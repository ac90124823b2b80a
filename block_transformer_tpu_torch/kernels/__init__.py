"""Hand-written CUDA kernels (K1-K3), each beside its plain PyTorch version."""
