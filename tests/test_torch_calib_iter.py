"""Parity of the port's calibration iteration and fleet engine with the JAX
package: the same numpy-drawn inputs through ``repro`` and ``repro_torch``.

Levels and bias are held exactly equal to the reference's eager jnp oracle
(both sum {-1, 0, 1} terms exactly, then divide by S once), and within 1e-7
of the Pallas kernel (which accumulates per 64-sample block) wherever that
kernel agrees with its own oracle; the columns where it does not are
counted exactly.  The last test compares the two
packages' own random streams statistically: mean ECR within 1.5 points on a
4 x 2048 grid.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.ecr import measure_ecr_fleet as j_ecr  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.core.fleet import calibrate_fleet as j_calibrate  # noqa: E402
from repro.core.fleet import fleet_calib_charges as j_charges  # noqa: E402
from repro.core.fleet import ladder_tables as j_tables  # noqa: E402
from repro.core.fleet import manufacture_fleet as j_manufacture  # noqa: E402
from repro.core.offsets import baseline_charges as j_base  # noqa: E402
from repro.kernels.majx import calib_iter_fused  # noqa: E402
from repro.kernels.ref import calib_iter_ref as j_calib_iter_ref  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.ecr import measure_ecr_fleet  # noqa: E402
from repro_torch.core.fleet import (FleetConfig, calibrate_fleet,  # noqa: E402
                                    fleet_calib_charges, ladder_tables,
                                    manufacture_fleet)
from repro_torch.core.offsets import baseline_charges  # noqa: E402
from repro_torch.kernels.calib_iter import calib_iter  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402

P, JP = PhysicsParams(), JPhys()
FRAC = (2, 1, 0)


def _inputs(seed, s=256, c=512, lead=()):
    rng = np.random.default_rng(seed)
    ladder = FleetConfig(frac_counts=FRAC).ladder(P)
    bits = rng.integers(0, 2, lead + (s, 5, c), dtype=np.uint8)
    noise = rng.standard_normal(lead + (s, c)).astype(np.float32)
    levels = rng.integers(0, ladder.n_levels, lead + (c,), dtype=np.int32)
    offs = (0.033 * rng.standard_normal(lead + (c,))).astype(np.float32)
    return ladder, bits, noise, levels, offs


def _port(bits, noise, levels, offs, ladder):
    qsum, swing = ladder_tables(ladder, P)
    lv, bias = calib_iter(torch.from_numpy(bits), torch.from_numpy(noise),
                          torch.from_numpy(levels), torch.from_numpy(offs),
                          P, ladder.n_fracs, qsum, swing, 0.0009, 5)
    return lv.numpy(), bias.numpy()


def _jax_args(bits, noise, levels, offs, ladder):
    qsum, swing = j_tables(ladder, JP)
    return (jnp.asarray(bits, jnp.float32), jnp.asarray(noise),
            jnp.asarray(levels), jnp.asarray(offs), JP, ladder.n_fracs,
            qsum, swing, 0.0009, 5)


def test_ladder_tables_equal():
    ladder = FleetConfig(frac_counts=FRAC).ladder(P)
    assert ladder_tables(ladder, P) == j_tables(ladder, JP)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_jnp_oracle_exactly(seed):
    ladder, bits, noise, levels, offs = _inputs(seed)
    lv, bias = _port(bits, noise, levels, offs, ladder)
    want_l, want_b = j_calib_iter_ref(*_jax_args(bits, noise, levels, offs,
                                                 ladder))
    np.testing.assert_array_equal(lv, np.asarray(want_l))
    np.testing.assert_array_equal(bias, np.asarray(want_b))
    assert lv.dtype == np.int32 and bias.dtype == np.float32
    assert (lv != levels).any()       # the step moved some levels


@pytest.mark.parametrize("seed, n_ties", [(0, 0), (7, 1)])
def test_plain_matches_pallas_kernel(seed, n_ties):
    """Levels equal and bias within 1e-7 of the Pallas kernel wherever the
    kernel agrees with the reference's own eager oracle.

    Under ``jit`` XLA turns the bitline division by 510 into a multiply by
    its reciprocal, one ulp off for most charge sums, so on rare threshold
    ties the Pallas kernel senses a bit its eager oracle does not: no column
    of 512 at seed 0, exactly one at seed 7.  The port follows the eager
    IEEE division.
    """
    ladder, bits, noise, levels, offs = _inputs(seed)
    lv, bias = _port(bits, noise, levels, offs, ladder)
    args = _jax_args(bits, noise, levels, offs, ladder)
    got_l, got_b = map(np.asarray, calib_iter_fused(*args, interpret=True))
    eager_b = np.asarray(j_calib_iter_ref(*args)[1])
    agree = np.isclose(got_b, eager_b, rtol=0, atol=1e-7)
    assert int((~agree).sum()) == n_ties
    np.testing.assert_array_equal(lv[agree], got_l[agree])
    np.testing.assert_allclose(bias[agree], got_b[agree], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(bias, eager_b)


def test_fleet_batch_axis_is_per_subarray():
    """A leading subarray axis equals running each subarray alone."""
    ladder, bits, noise, levels, offs = _inputs(3, c=256, lead=(3,))
    lv, bias = _port(bits, noise, levels, offs, ladder)
    for g in range(3):
        lg, bg = _port(bits[g], noise[g], levels[g], offs[g], ladder)
        np.testing.assert_array_equal(lv[g], lg)
        np.testing.assert_array_equal(bias[g], bg)


def test_twelve_iterations_on_jax_draws_match_calibrate_fleet():
    """Feed the port the exact per-iteration draws of the reference's fleet
    engine; the final levels equal ``calibrate_fleet(method="reference")``.

    The jitted reference divides by multiplying with a reciprocal (see the
    Pallas test above); on this draw no such ulp flips a level step.
    """
    jcfg = JFleet(n_channels=1, n_banks=1, n_subarrays=2, n_cols=256)
    jcal = JCal(n_iterations=12, n_samples=256)
    key = jax.random.key(5)
    offs = j_manufacture(key, jcfg, JP)
    want = j_calibrate(key, offs, jcfg, JP, jcal, method="reference")

    ladder = FleetConfig(frac_counts=FRAC).ladder(P)
    qsum, swing = ladder_tables(ladder, P)
    g, c = offs.shape
    levels = torch.full((g, c), 3, dtype=torch.int32)
    toffs = torch.from_numpy(np.array(offs))
    for it_key in jax.random.split(key, jcal.n_iterations):
        k_in, k_noise = jax.random.split(it_key)
        bits = jax.random.bernoulli(k_in, 0.5, (g, jcal.n_samples, 5, c))
        noise = jax.random.normal(k_noise, (g, jcal.n_samples, c),
                                  jnp.float32)
        levels, _ = calib_iter(
            torch.from_numpy(np.asarray(bits, np.uint8)),
            torch.from_numpy(np.array(noise)), levels, toffs, P,
            ladder.n_fracs, qsum, swing, jcal.threshold, 5)
    np.testing.assert_array_equal(levels.numpy(), np.asarray(want.levels))


def test_fleet_ecr_matches_reference_statistically():
    """The port's own generators vs the reference's jax.random streams:
    uncalibrated B_{3,0,0} and calibrated T_{2,1,0} mean ECR agree within
    1.5 points on a 4 x 2048 grid."""
    cfg = FleetConfig(n_channels=1, n_banks=1, n_subarrays=4, n_cols=2048)
    jcfg = JFleet(n_channels=1, n_banks=1, n_subarrays=4, n_cols=2048)
    cal = CalibrationConfig(n_iterations=12, n_samples=256)
    jcal = JCal(n_iterations=12, n_samples=256)
    g, c = cfg.n_subarrays_total, cfg.n_cols

    offs = manufacture_fleet(11, cfg, P, device="cpu")
    fleet = calibrate_fleet(11, offs, cfg, P, cal)
    levels, hist = fleet.levels, fleet.mean_abs_bias
    assert hist.shape == (12,) and hist[-1] < 0.3 * hist[0]   # converges
    ladder = cfg.ladder(P)
    t210, _ = measure_ecr_fleet(12, offs, fleet_calib_charges(
        ladder, levels, P), P, ladder.n_fracs, n_trials=1024)
    base = baseline_charges(3, c, P)[None].expand(g, 3, c)
    b300, _ = measure_ecr_fleet(13, offs, base, P, 3, n_trials=1024)

    key = jax.random.key(11)
    joffs = j_manufacture(key, jcfg, JP)
    jlev = j_calibrate(key, joffs, jcfg, JP, jcal, method="reference").levels
    jt210, _ = j_ecr(jax.random.key(12), joffs,
                     j_charges(ladder, jlev, JP), JP, ladder.n_fracs,
                     n_trials=1024)
    jb300, _ = j_ecr(jax.random.key(13), joffs, jnp.broadcast_to(
        j_base(3, c, JP)[None], (g, 3, c)), JP, 3, n_trials=1024)

    port = (float(b300.mean()), float(t210.mean()))
    ref = (float(jnp.mean(jb300)), float(jnp.mean(jt210)))
    assert abs(port[0] - ref[0]) < 0.015, (port, ref)
    assert abs(port[1] - ref[1]) < 0.015, (port, ref)
    assert port[1] < 0.1 < 0.3 < port[0]     # calibration does its job
