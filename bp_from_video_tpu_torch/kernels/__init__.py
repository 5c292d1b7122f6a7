"""Hand-written CUDA kernels (wrappers, plain versions, build)."""
