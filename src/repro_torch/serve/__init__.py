"""Single-device serving of the cognitive tick: host staging and the
double buffer (``transport``), the device tick (``engine_core``), the
slot API (``cognitive_engine``), and the continuously batched,
self-healing fleet (``fleet``, with ``scheduler``, ``supervisor`` and
``faults``)."""
