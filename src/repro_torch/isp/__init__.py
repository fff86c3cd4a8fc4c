"""The Cognitive ISP (paper §V) on the plain PyTorch backend."""
