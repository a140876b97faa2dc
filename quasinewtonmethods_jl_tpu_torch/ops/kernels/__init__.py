"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (the counterpart of the JAX package's ``ops/pallas``)."""
