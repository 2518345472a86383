"""The paper's figures in the port (``repro_torch.benchmarks``) beside the
reference's own runs (``benchmarks/``) at one small scale on the CPU.

The two packages draw their manufactured subarrays, calibration samples
and trial patterns from different random streams, so each ECR is held
statistically: the port's and the reference's are two independent
estimates of one column probability over ``n`` columns, and they must lie
within 4 binomial sigmas, ``4 * sqrt(2 p (1 - p) / n)`` at the pooled
``p`` (floored at one column).  Columns, methods, iteration budgets,
ladder sizes and the modeled latencies are deterministic and held equal.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro_torch.benchmarks import (calibration_convergence,  # noqa: E402
                                    common, fig5_frac_sensitivity,
                                    fig6_reliability, majx_general)

SMALL = dict(n_cols=512, n_trials_maj5=256)


def _tol(a: float, b: float, n: int) -> float:
    p = min(max((a + b) / 2, 1 / n), 1 - 1 / n)
    return 4 * np.sqrt(2 * p * (1 - p) / n)


def _ref_scale():
    from benchmarks.common import BenchScale
    return BenchScale(**SMALL)


#: Fig. 5's methods in this test: both of the paper's ratios (T210 over
#: T000 and T222), the best configuration (T100) and matched baselines.
#: Each ladder costs the reference a compilation, so not all 15.
FIG5 = (("B000", "B300"), ("T000", "T100", "T210", "T222"))


def test_fig5_within_binomial_of_reference(monkeypatch):
    from benchmarks import fig5_frac_sensitivity as ref
    for mod in (ref, fig5_frac_sensitivity):
        monkeypatch.setattr(mod, "BASELINES", FIG5[0])
        monkeypatch.setattr(mod, "PUDTUNE", FIG5[1])
    rows = fig5_frac_sensitivity.run(common.BenchScale(**SMALL),
                                     device="cpu")
    want = ref.run(_ref_scale())
    assert [list(r) for r in rows] == [list(r) for r in want]
    assert [r["method"] for r in rows] == list(FIG5[0] + FIG5[1])
    n = SMALL["n_cols"]
    for r, w in zip(rows, want):
        assert (r["method"], r["kind"], r["n_fracs"]) == \
            (w["method"], w["kind"], w["n_fracs"])
        assert r["maj5_latency_us"] == w["maj5_latency_us"]
        a, b = r["ecr_pct"] / 100, w["ecr_pct"] / 100
        assert abs(a - b) <= _tol(a, b, n), (r, w)


def test_fig6_within_binomial_of_reference():
    from benchmarks import fig6_reliability as ref
    scale = dict(n_cols=1024, n_trials_maj5=256)
    from benchmarks.common import BenchScale
    temps, times = fig6_reliability.run(common.BenchScale(**scale),
                                        device="cpu")
    w_temps, w_times = ref.run(BenchScale(**scale))
    for got, want in ((temps, w_temps), (times, w_times)):
        assert [list(r) for r in got] == [list(r) for r in want]
        for r, w in zip(got, want):
            assert list(r.values())[0] == list(w.values())[0]
            for k in ("ecr_pct", "new_ecr_pct"):
                a, b = r[k] / 100, w[k] / 100
                assert abs(a - b) <= _tol(a, b, scale["n_cols"]), (k, r, w)


def test_convergence_within_binomial_of_reference():
    from benchmarks import calibration_convergence as ref
    rows = calibration_convergence.run(common.BenchScale(**SMALL),
                                       device="cpu")
    want = ref.run(_ref_scale())
    assert [list(r) for r in rows] == [list(r) for r in want]
    assert [r["iterations"] for r in rows] == [1, 2, 5, 10, 15, 20, 30]
    for r, w in zip(rows, want):
        assert r["iterations"] == w["iterations"]
        a, b = r["ecr_pct"] / 100, w["ecr_pct"] / 100
        assert abs(a - b) <= _tol(a, b, SMALL["n_cols"]), (r, w)
    # the bias walk converges: the last budgets' mean |bias| is small
    assert rows[-1]["mean_abs_bias_last"] < rows[0]["mean_abs_bias_last"]


def test_majx_within_binomial_of_reference():
    from benchmarks import majx_general as ref
    rows = majx_general.run(common.BenchScale(**SMALL), device="cpu")
    want = ref.run(_ref_scale())
    assert [list(r) for r in rows] == [list(r) for r in want]
    for r, w in zip(rows, want):
        assert (r["majx"], r["calib_rows"], r["ladder_levels"]) == \
            (w["majx"], w["calib_rows"], w["ladder_levels"])
        for k in ("ecr_uncalibrated_pct", "ecr_pudtune_pct"):
            a, b = r[k] / 100, w[k] / 100
            assert abs(a - b) <= _tol(a, b, SMALL["n_cols"]), (k, r, w)


def test_majx_neutral_charges_equal_reference():
    from benchmarks.majx_general import _neutral_charges as ref
    from repro.pud.physics import PhysicsParams as JPhys
    from repro_torch.pud.physics import PhysicsParams
    for fc in ((2, 1, 0), (1,), (2, 1, 0, 1)):
        got = majx_general._neutral_charges(fc, 7, PhysicsParams(), "cpu")
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref(fc, 7, JPhys())))


