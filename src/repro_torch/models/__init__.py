"""The LM stack (the counterpart of ``repro.models``): dense GQA
attention blocks, the layer layout, prefill and decode."""
