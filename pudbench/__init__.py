"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 pudbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line; see
``pudbench/README.md``.
"""
