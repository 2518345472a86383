"""``chip_smoke.py``'s deepseek group on the CPU at smoke size, through the
plain versions: deepseek-v2-lite (MLA, MoE) prefill, lockstep, engine and
ragged runs, ``--pud-attention``, and the kernel rows at its shapes."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import check_rows, rehearse  # noqa: E402


def test_deepseek_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("deepseek", capsys, tmp_path, monkeypatch)
    check_rows(out, ["gemm_placed", "gemv_placed"], [6, 1])
    ds = out["deepseek"]                 # the deepseek-v2-lite phase
    assert 0 < ds["placed_cols"] < ds["attn_cols"]
    assert ds["engine"]["steps"] > 0 and ds["peak_gib"] is None
    assert "deepseek-v2-lite-16b (smoke)" in text
    assert "requests equal to lockstep" in text
    assert "--pud-attention: MLA wq / wo packed too" in text
