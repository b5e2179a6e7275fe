"""The port's hand-written CUDA kernels: sources in `csrc/`, the
nvcc builder, plain PyTorch versions and the wrappers."""
