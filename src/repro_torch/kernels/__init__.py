"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version: ``spike_conv`` (gated implicit-im2col conv),
``spike_conv_lif`` (the fused conv->norm->LIF layer), ``spike_dwconv``
(gated depthwise conv),
``max_pool`` (gated spike pooling), ``spike_matmul`` (tile-skip GEMM),
``lif_scan`` and ``norm_affine_lif`` (the NPU), ``event_voxel`` (DVS
encoding), ``demosaic`` and ``nlm`` (the ISP), ``isp_fused`` (the fused
ISP's pointwise and stencil segments), ``backbone_segment`` (a planned
run of spiking conv layers in one launch; its planner is
``backbone_fuse``).  ``build`` compiles ``csrc/`` with ``nvcc`` at first
use; ``ops`` dispatches the spiking layers onto them, through the launch
table of ``tune`` for a firing conv layer and a backbone segment."""
