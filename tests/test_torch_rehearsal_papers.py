"""``chip_smoke.py``'s papers group on the CPU at smoke size, through the
plain versions: Table I, the fleet benchmark, the figures, the
quickstart, the command-level simulator, the dense layout through the
``ops`` entries, the contract gate and the benchmarks, with their kernel
rows."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import check_rows, rehearse  # noqa: E402


def test_papers_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("papers", capsys, tmp_path, monkeypatch)
    check_rows(out, ["calib_iter", "gemm_placed", "gemv_placed", "gemm",
                     "gemv", "majx_sense"], [2, 1, 1, 2, 1, 3])
    for r in out["rows"][1:5]:           # the dense layout on every entry
        assert {e["layout"] for e in [r] + r["extra_shapes"]} == {"dense"}
    t1 = out["table1"]
    assert t1["T210"]["ecr"] < t1["B300"]["ecr"]
    assert out["quickstart"]["tuned"] < out["quickstart"]["baseline"]
    assert abs(out["simra"]["ecr_cmd"] - out["simra"]["ecr_fast"]) \
        <= out["simra"]["tol"]
    assert "gains T210/B300" in text and "command level" in text
    assert "#csv fleet_calibration" in text and "#csv table1" in text
    assert "main leg == reference on the same inputs" in text
    figs = out["figures"]                # the paper's figures phase
    assert list(figs["walls_s"]) == ["fig3", "fig5", "fig6", "convergence",
                                     "drift", "majx", "placement"]
    for name in ("fig3_offsets", "fig5_frac_sensitivity", "fig6_temperature",
                 "fig6_time", "calibration_convergence", "drift_recovery",
                 "majx_general", "placement"):
        assert f"#csv {name}" in text
    for name in ("drift_recovery", "placement"):
        assert (f"{name}: kernels == plain versions on the same inputs"
                in text)
    assert out["contracts"]["sms"] == 132 and "0 findings" in text
    assert set(out["benchmarks"]) == {"serving", "serving_engine",
                                      "kernels", "kernel_microbench"}
    assert "#csv serving_trace" in text
    for name in ("mvdram_serving", "kernel_bench", "kernel_microbench"):
        assert f"#csv {name}" in text
    for name in ("kernel_bench", "kernel_microbench"):
        assert (f"{name}: kernels == plain versions on the same inputs"
                in text)
