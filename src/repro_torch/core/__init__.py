"""The NPU of the serving tick: LIF neurons, spiking layers, the
spiking-YOLO backbone and head, event encoding and sparsity metrics."""
