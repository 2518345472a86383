"""The control of each cell's comparison, on the chip at the cell's own
size: the reference computed one precision below the configuration's
(float8 operands in every bf16 product) puts first tokens whose gap, in
the configuration-precision reference's logits, is past the cell's limit,
while the program's own reading stays inside it.  Runs ``control.py``
(one seed, a short window) on a CUDA device; skips without one:

    PYTHONPATH=src python -m pytest -q -m gpu pudbench/tests/\
test_pudbench_control.py
"""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["dsv2lite-rag", "mamba2-longdoc"])
def test_control_fails_and_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size on the chip")
    wl = json.loads((ROOT / "pudbench" / "workloads" / f"{cell}.json")
                    .read_text())
    out = subprocess.run(
        [sys.executable, "pudbench/control.py", "--workload", cell,
         "--seeds", "4242", "--seconds", "5"], cwd=ROOT, check=True,
        capture_output=True, text=True, timeout=1200).stdout
    row = json.loads(out.strip().splitlines()[-1])
    limit = wl["correct"]["widest_gap"]
    assert row["program_widest_gap"] <= limit
    assert row["control_widest_gap"] > limit
