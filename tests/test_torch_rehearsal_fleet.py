"""``chip_smoke.py``'s fleet group on the CPU at smoke size, through the
plain versions: the sharded fleet on a (2, 2) mesh with checks (a) to
(e), and the kernel rows at its per-shard shapes."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import check_rows, rehearse  # noqa: E402


def test_fleet_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("fleet", capsys, tmp_path, monkeypatch)
    check_rows(out, ["calib_iter", "gemm_placed", "gemv_placed", "gemm",
                     "gemv"], [1, 3, 1, 1, 1])
    fl = out["fleet"]
    assert min(fl["shard_widths"]) > 0   # both shards own columns
    assert fl["events"] and {s for s, _ in fl["events"]} == {1}
    assert 0 < fl["scaling_efficiency"] <= 1 and fl["aggregate_tok_s"] > 0
    assert "positions -> cards: (0,0)->cpu" in text
    assert "every table HIT" in text and "every placement HIT" in text
    assert text.count("== the single-device engine's, bit for bit") == 2
    assert "through the kernels == plain versions, bit for bit" in text
    assert "== plain version), masks and placement rebuilt" in text
    assert "recalibrated shard 1 only" in text
    assert "batch-1 tokens == the placed lane's" in text
    assert "PUDFleetSession.tune on the CPU raises" in text
