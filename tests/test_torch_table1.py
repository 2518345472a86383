"""Parity of the port's Table-I path with the JAX package, on the CPU:
Algorithm 1 on one subarray (``core/calibrate``), the ECR measurements
(``core/ecr``), the Eq.-1 throughput (``core/throughput``) and the
session's baseline ECR.

Tolerances and why:
  * at zero sensing sigma (the offsets alone decide a column) levels and
    error-prone masks are exact: the outcome of a column is then a function
    of which input patterns occur, and at these trial counts every class of
    pattern occurs in both packages' draws;
  * at default physics the two packages draw different noise, so ECRs
    agree within 4 standard deviations of a binomial share over the
    columns: |a - b| <= 4 sqrt(2 e (1 - e) / n), e their mean;
  * the throughput model and ``expected_ecr_maj5`` are host arithmetic on
    given ECRs and offsets: 1e-6 relative (float32 transcendental
    functions differ between the libraries in the last bits).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import calibrate as jcal  # noqa: E402
from repro.core import ecr as jecr  # noqa: E402
from repro.core import throughput as jtp  # noqa: E402
from repro.core.offsets import baseline_charges as j_base  # noqa: E402
from repro.pud.bitserial import MajContext as JCtx  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro.pud.timing import SystemConfig as JSys  # noqa: E402
from repro_torch.core import calibrate, ecr, throughput  # noqa: E402
from repro_torch.core.fleet import (FleetConfig, calibrate_fleet,  # noqa: E402
                                    manufacture_fleet)
from repro_torch.core.offsets import (baseline_charges,  # noqa: E402
                                      levels_to_charges, make_ladder)
from repro_torch.core.rng import generator  # noqa: E402
from repro_torch.pud.bitserial import MajContext  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

ZERO_SIGMA = dict(sigma_dynamic=0.0, sigma_frac=0.0, sigma_transfer=0.0)
FRAC = (2, 1, 0)


def _offsets(seed, n):
    rng = np.random.default_rng(seed)
    return (0.033281 * rng.standard_normal(n)).astype(np.float32)


def _binomial_close(a, b, n):
    e = (a + b) / 2
    assert abs(a - b) <= 4 * math.sqrt(2 * e * (1 - e) / n) + 1e-12, (a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_identify_calibration_equals_reference_at_zero_sigma(seed):
    offs = _offsets(seed, 512)
    p, jp = PhysicsParams(**ZERO_SIGMA), JPhys(**ZERO_SIGMA)
    ladder = make_ladder(FRAC, p)
    cfg = calibrate.CalibrationConfig(n_iterations=8, n_samples=128)
    jcfg = jcal.CalibrationConfig(n_iterations=8, n_samples=128)
    got = calibrate.identify_calibration(
        torch.Generator().manual_seed(seed), torch.from_numpy(offs), ladder,
        p, cfg)
    want = jcal.identify_calibration(jax.random.key(seed), jnp.asarray(offs),
                                     ladder, jp, jcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) > 3          # the walk moved the columns
    levels, hist = calibrate.calibration_history(
        torch.Generator().manual_seed(seed), torch.from_numpy(offs), ladder,
        p, cfg)
    assert torch.equal(levels, got) and len(hist) == 8
    assert hist[-1] < hist[0]


def test_per_subarray_method_is_identify_calibration_per_subarray():
    cfg = FleetConfig(n_channels=1, n_banks=1, n_subarrays=3, n_cols=256)
    p = PhysicsParams()
    ccfg = calibrate.CalibrationConfig(n_iterations=4, n_samples=64)
    offs = manufacture_fleet(9, cfg, p, device="cpu")
    fleet = calibrate_fleet(9, offs, cfg, p, ccfg, method="per_subarray")
    assert fleet.mean_abs_bias is None and fleet.levels.shape == (3, 256)
    for g in range(3):
        alone = calibrate.identify_calibration(
            generator(9, "calibrate", g), offs[g], cfg.ladder(p), p, ccfg)
        assert torch.equal(fleet.levels[g], alone)


def _charges(kind, offs, p, jp):
    """(port, reference) calibration-row charges: B_{3,0,0}, or T_{2,1,0}
    at the levels the reference's Algorithm 1 finds at zero sigma."""
    n = offs.shape[0]
    if kind == "B300":
        return (baseline_charges(3, n, p),
                j_base(3, n, jp), 3)
    ladder = make_ladder(FRAC, p)
    levels = jcal.identify_calibration(
        jax.random.key(3), jnp.asarray(offs), ladder, jp,
        jcal.CalibrationConfig(n_iterations=8, n_samples=128))
    from repro.core.offsets import levels_to_charges as j_l2c
    return (levels_to_charges(ladder, torch.from_numpy(np.array(levels)),
                              p),
            j_l2c(ladder, levels, jp), ladder.n_fracs)


@pytest.mark.parametrize("kind", ["B300", "T210"])
def test_maj_ecr_equals_reference_at_zero_sigma(kind):
    offs = _offsets(5, 2048)
    p, jp = PhysicsParams(**ZERO_SIGMA), JPhys(**ZERO_SIGMA)
    cc, jcc, nf = _charges(kind, offs, p, jp)
    got, mask = ecr.measure_ecr_maj5(torch.Generator().manual_seed(1),
                                     torch.from_numpy(offs), cc, p, nf,
                                     n_trials=512)
    want, jmask = jecr.measure_ecr_maj5(jax.random.key(1), jnp.asarray(offs),
                                        jcc, jp, nf, n_trials=512)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert got == want and 0 < got < 1
    # MAJ3: three inputs, the 0/1 constant pair, three calibration rows
    got3, mask3 = ecr.measure_ecr_majx(
        torch.Generator().manual_seed(2), torch.from_numpy(offs), cc, p, nf,
        3, const_charge_sum=1.0, const_swing_sq=2.0, n_trials=512)
    want3, jmask3 = jecr.measure_ecr_majx(
        jax.random.key(2), jnp.asarray(offs), jcc, jp, nf, 3,
        const_charge_sum=1.0, const_swing_sq=2.0, n_trials=512)
    np.testing.assert_array_equal(mask3.numpy(), np.asarray(jmask3))
    assert got3 == want3


@pytest.mark.parametrize("op", ["add8", "mul8"])
def test_graph_ecr_equals_reference_at_zero_sigma(op):
    offs = _offsets(6, 256)
    p, jp = PhysicsParams(**ZERO_SIGMA), JPhys(**ZERO_SIGMA)
    cc, jcc, nf = _charges("B300", offs, p, jp)
    ctx = MajContext(p, torch.from_numpy(offs), cc, nf)
    jctx = JCtx(jp, jnp.asarray(offs), jcc, nf)
    n_trials = 256 if op == "add8" else 128
    got, mask = ecr.measure_ecr_graph(torch.Generator().manual_seed(3), ctx,
                                      op, n_trials=n_trials)
    want, jmask = jecr.measure_ecr_graph(jax.random.key(3), jctx, op,
                                         n_trials=n_trials)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert got == want and 0 < got < 1


@pytest.mark.parametrize("kind", ["B300", "T210"])
def test_maj5_ecr_matches_reference_statistically(kind):
    """Default physics, the same offsets and charges, each package its own
    noise: the ECRs agree within the binomial tolerance."""
    n = 4096
    offs = _offsets(7, n)
    p, jp = PhysicsParams(), JPhys()
    cc, jcc, nf = _charges(kind, offs, p, jp)
    got, _ = ecr.measure_ecr_maj5(torch.Generator().manual_seed(4),
                                  torch.from_numpy(offs), cc, p, nf,
                                  n_trials=1024)
    want, _ = jecr.measure_ecr_maj5(jax.random.key(4), jnp.asarray(offs),
                                    jcc, jp, nf, n_trials=1024)
    _binomial_close(got, want, n)


def test_expected_ecr_and_throughput_equal_reference():
    offs = _offsets(8, 4096)
    units = np.random.default_rng(9).choice([-0.5, 0.0, 0.5], 4096).astype(
        np.float32)
    for nf, swing in ((3, 2.5), (0, 1.0)):
        got = ecr.expected_ecr_maj5(torch.from_numpy(offs),
                                    torch.from_numpy(units), PhysicsParams(),
                                    nf, swing)
        want = jecr.expected_ecr_maj5(jnp.asarray(offs), jnp.asarray(units),
                                      JPhys(), nf, swing)
        assert 0.05 < float(got) < 0.95
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for op in ("maj5", "add8", "mul8"):
        ecrs = [0.466, 0.033, 0.2, 0.0]
        got = throughput.fleet_throughput(
            "T210", op, torch.tensor(ecrs, dtype=torch.float64), 3)
        want = jtp.fleet_throughput("T210", op, ecrs, 3, JSys())
        np.testing.assert_allclose(got.per_subarray, want.per_subarray,
                                   rtol=1e-6)
        np.testing.assert_allclose(got.aggregate, want.aggregate, rtol=1e-6)
        assert got.row() == want.row()
    assert throughput._parse_method("T210") == jtp._parse_method("T210")
    assert throughput._parse_method("B300") == ("baseline", (3, 0, 0))


def test_evaluate_method_orders_the_methods():
    """One small Table-I run per method on the CPU: the same seed is the
    same device, T_{2,1,0} beats B_{3,0,0} on every ECR and rate, and the
    rows have the reference's format."""
    kw = dict(n_cols=2048, n_trials_maj5=512, n_cols_arith=128,
              n_trials_arith=128, device="cpu",
              calib_config=calibrate.CalibrationConfig(n_iterations=10,
                                                       n_samples=128))
    b = throughput.evaluate_method(1, "B300", **kw)
    t = throughput.evaluate_method(1, "T210", **kw)
    assert t.ecr < 0.15 < 0.3 < b.ecr and t.ecr_add < b.ecr_add
    assert t.ecr_mul < b.ecr_mul
    assert t.maj5_tops > b.maj5_tops and t.add8_gops > b.add8_gops
    assert b.levels is None and t.levels.shape == (2048,)
    assert set(t.stage_s) == {"calibrate", "ecr_maj5", "ecr_graph"}
    assert t.row().startswith("T210,") and len(t.row().split(",")) == 5
    jrow = jtp.MethodResult("T210", t.ecr, t.ecr_add, t.ecr_mul, t.maj5_tops,
                            t.add8_gops, t.mul8_gops, t.maj5_latency_us)
    assert t.row() == jrow.row()


def test_session_baseline_ecr_matches_reference_statistically():
    """The quickstart's before-picture: B_{3,0,0} mean ECR of the session's
    device, against the reference session's own device (different draws,
    so offsets differ too: binomial tolerance over all columns, doubled)."""
    from repro.api import FleetConfig as JFleet
    from repro.api import PUDSession as JSession
    grid = dict(n_channels=1, n_banks=1, n_subarrays=2, n_cols=2048)
    got = PUDSession.open(FleetConfig(**grid), device="cpu",
                          n_trials_ecr=512).baseline_ecr()
    want = JSession.open(JFleet(**grid), key=0,
                         n_trials_ecr=512).baseline_ecr()
    e = (got + want) / 2
    assert abs(got - want) <= 8 * math.sqrt(2 * e * (1 - e) / 4096)
    assert 0.35 < got < 0.6
