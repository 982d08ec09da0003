"""The benchmark of tpu_mpi_torch, the PyTorch and CUDA port of tpu_mpi.

One run measures one cell of ``BENCHMARK.json``:
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
Everything that belongs to one configuration, traffic mix, cell or per-layer
metric sits in a file of its own under ``configs/``, ``traffic/``,
``workloads/`` and ``metrics/``, found by the name in ``BENCHMARK.json``.
"""
