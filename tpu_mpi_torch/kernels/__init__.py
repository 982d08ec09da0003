"""Hand-written CUDA kernels of the port, one module per TPU kernel it
replaces. Each module holds the kernel's wrapper, its plain PyTorch
version and its launch counter; sources live in ``tpu_mpi_torch/csrc``."""
