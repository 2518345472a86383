"""``chip_smoke.py``'s main group on the CPU at smoke size, through the
plain versions: qwen3's placed main path, the reopen, partial
recalibration, fault injection, the unplaced engine path, the ragged run,
the pack archive, monitored serving, tuning and ``--weight-bits``, and
the kernel rows at their shapes."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import check_rows, rehearse  # noqa: E402


def test_main_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("main", capsys, tmp_path, monkeypatch)
    check_rows(out, ["calib_iter", "gemm_placed", "gemv_placed", "gemm",
                     "gemv"], [1, 7, 2, 5, 2])
    for r in out["rows"][1:5]:           # the dense layout on every entry
        assert r["extra_shapes"][-1]["layout"] == "dense"
    assert "placement HIT" in text and "bit for bit" in text
    assert "unplaced engine path" in text and "100.0% of requests" in text
    assert "plan: dp4a" in text and "plan: tensor cores" in text
    assert "other 6 rows of levels, ECR and masks unchanged" in text
    assert out["faults"]["delta"] > 0.1
    assert set(out["archive"]) == {"placed", "unplaced"}
    mon = out["monitor"]                 # the monitored serving phase
    assert {g for g, sev in mon["events"] if sev == "critical"} == {1, 5}
    assert mon["latency_steps"] >= 0 and mon["recalibrate_ms"] > 0
    assert "post-swap spot check: 2/2" in text
    assert "other rows of the persisted table unchanged" in text
    tun = out["tuning"]                  # the tuning phase (untimed stamps)
    assert 0 < tun["occupancy"] < 1 and tun["used_cols"] > 0
    assert "PUDSession.tune on the CPU raises" in text
    assert "tuned kernels == plain versions, bit for bit" in text
    assert "tokens and logits bit-identical" in text
    assert set(tun["single_split"]) == {"wi", "wo"} and "one split" in text
    assert tun["plan_path_us"] > 0 and "stamped-plan host path" in text
    assert "saved and loaded: plans equal" in text
    assert "packs of 8 planes: prefill logits" in text
    assert "(phase wall" in text
