"""Hand-written CUDA kernels of the port, one module per TPU kernel it
replaces. Each module holds the kernel's wrapper and its plain PyTorch
version; ``_build`` builds and launches them and keeps the one table of
launch counts. Sources live in ``tpu_mpi_torch/csrc``."""
