"""The port's counterparts of the reference's paper benchmarks
(``benchmarks/table1.py``, ``benchmarks/fleet_calibration.py``): the same
CLI flags and ``#csv`` blocks, plus ``--device`` (default the GPU).

    python -m repro_torch.benchmarks.table1 [--full] [--device cpu]
    python -m repro_torch.benchmarks.fleet_calibration [--full] [--device cpu]
"""
