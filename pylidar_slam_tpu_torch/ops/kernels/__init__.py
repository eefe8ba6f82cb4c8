"""Hand-written CUDA kernels for Hopper (sm_90a), one module each, with the
plain PyTorch version of the same function beside every wrapper."""
