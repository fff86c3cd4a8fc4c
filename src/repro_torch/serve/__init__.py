"""Single-device serving of the cognitive tick: host staging
(``transport``), the device tick (``engine_core``) and the slot API
(``cognitive_engine``)."""
