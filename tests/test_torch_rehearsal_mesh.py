"""``chip_smoke.py``'s mesh group on the CPU at smoke size: qwen3 trained
3 steps on a (2, 2) mesh of CPU positions and on one device (losses within
the reference's mesh-test tolerances), every arch's smoke step on the mesh
against the one-device step, the 4-stage pipeline == sequential, and
mamba2 on a (2, 2) fleet (vocab widened to 512 so both unembed shards own
columns) == the single-device engine and the plain versions."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import check_rows, rehearse  # noqa: E402


def test_mesh_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("mesh", capsys, tmp_path, monkeypatch)
    check_rows(out, ["gemm_placed", "gemv_placed"], [1, 1])
    me = out["mesh"]
    tr = me["train"]
    assert len(tr["mesh"]["losses"]) == len(tr["one"]["losses"]) == 3
    assert sorted(tr["mesh"]["bytes_per_position"]) == [
        "(0, 0)", "(0, 1)", "(1, 0)", "(1, 1)"]
    assert tr["param_err"] < 2e-2
    assert len(me["smoke"]) == 20
    assert all(r["grad_ratio"] <= 1 and r["param_ratio"] <= 1
               for r in me["smoke"].values())
    assert me["pipeline"]["bubble"] == pytest.approx(1 / 9)    # 2 stages
    fl = me["fleet"]
    assert all(w > 0 for w in fl["shard_widths"])
    assert "== sequential application, bit for bit" in text
    assert "== the single-device engine's and == the plain versions'" in text
