"""``chip_smoke.py``'s gemma group on the CPU at smoke size, through the
plain versions: gemma-7b through the engine's scheduler (chunked prefill,
prefix cache, SLO admission) and the kernel rows at its shapes."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import check_rows, rehearse  # noqa: E402


def test_gemma_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("gemma", capsys, tmp_path, monkeypatch)
    check_rows(out, ["calib_iter", "gemm_placed", "gemv_placed"], [1, 3, 1])
    gem = out["gemma"]                   # the gemma phase's scheduler runs
    assert gem["hits"] == (2, 7)
    assert gem["prefilled"][0] < gem["prefilled"][1]
    assert gem["slo"]["shed_on_admit"] >= 1 and gem["slo"]["met"] >= 1
    assert "gemma-7b (smoke)" in text and "bit for bit" in text
