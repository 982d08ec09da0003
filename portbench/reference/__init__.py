"""Plain PyTorch references that judge the program's outputs. They import
nothing of tpu_mpi_torch and take nothing the program made."""
