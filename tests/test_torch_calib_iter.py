"""Parity of the port's calibration iteration and fleet engine with the JAX
package: the same numpy-drawn inputs through ``repro`` and ``repro_torch``.

Levels and bias are held exactly equal to the reference's eager jnp oracle
(both sum {-1, 0, 1} terms exactly, then divide by S once), and within 1e-7
of the Pallas kernel (which accumulates per 64-sample block) wherever that
kernel agrees with its own oracle; the columns where it does not are
counted exactly.  The last test compares the two
packages' own random streams statistically: mean ECR within 1.5 points on a
4 x 2048 grid.  The CUDA kernel's schedule is emulated on the CPU and held
to the plain version bit for bit, and its host launch plan is checked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

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
from repro_torch.kernels.calib_iter import (COLS, SMEM_DEFAULT,  # noqa: E402
                                          SMEM_MAX, THREADS, Plan,
                                          calib_iter, calib_iter_plain,
                                          plan_launch)
from repro_torch.pud.physics import NEUTRAL, PhysicsParams  # noqa: E402

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


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule (csrc/calib_iter.cu), emulated on the CPU
# ---------------------------------------------------------------------------

def _emulate_kernel(inputs, noise, levels, offs, params, n_fracs, qsum,
                    swing, threshold, m, const_charge=0.0, const_swing=0.0,
                    aligned=True):
    """Plain PyTorch emulation of ``csrc/calib_iter.cu`` under the wrapper's
    plan: per column a table of its M + 1 bitline voltages; each thread's
    ``COLS`` columns' operand bytes summed as little-endian 32-bit words
    (vector path) or byte by byte and packed into such a word (byte path,
    where the columns past C read as zeros and are dropped at the store);
    a sample is a table lookup, one multiply, one add and two compares."""
    *lead, s, _, c = inputs.shape
    g = int(np.prod(lead)) if lead else 1
    plan = plan_launch(g, m, c, aligned)
    cols = COLS
    cp = -(-c // cols) * cols
    x = inputs.reshape(g, s, m, c)
    shifts = 8 * torch.arange(cols, dtype=torch.int64)
    if plan.vec:
        words = np.ascontiguousarray(x.numpy()).view("<u4")
        w = torch.from_numpy(words.astype(np.int64)).sum(dim=2)
    else:
        ones = torch.nn.functional.pad(x.to(torch.int64).sum(dim=2),
                                       (0, cp - c))
        w = (ones.reshape(g, s, cp // cols, cols) << shifts).sum(dim=-1)
    counts = ((w[..., None] >> shifts) & 0xFF).reshape(g, s, cp).clamp(max=m)

    def pad(t):
        return torch.nn.functional.pad(t, (0, cp - c))

    lv = pad(levels.reshape(g, c))
    nz = pad(noise.reshape(g, s, c))
    f = np.float32
    qs = torch.tensor(qsum, dtype=torch.float32)[lv.long()]
    sw = torch.tensor(swing, dtype=torch.float32)[lv.long()]
    one = torch.ones((), dtype=torch.float32)
    k = {name: one * float(f(v)) for name, v in dict(
        c_cell=params.c_cell_ff, neutral_bl=NEUTRAL * params.c_bitline_ff,
        c_total=params.c_total_ff(params.n_simra_rows), neutral=NEUTRAL,
        var_const=f(params.sigma_dynamic ** 2)
        + f(params.sigma_frac ** 2) * f(n_fracs),
        st2=params.sigma_transfer ** 2, const_charge=const_charge,
        const_swing=const_swing, m=m, s=s, thr=threshold,
        neg_thr=-threshold).items()}
    o = torch.arange(m + 1, dtype=torch.float32)[:, None, None]
    table = (((o + qs) + k["const_charge"]) * k["c_cell"]
             + k["neutral_bl"]) / k["c_total"]              # [M + 1, g, cp]
    sigma = torch.sqrt(k["var_const"] + k["st2"]
                       * ((k["m"] + sw) + k["const_swing"]))
    thr = k["neutral"] + pad(offs.reshape(g, c))
    v = torch.gather(table.permute(1, 2, 0)[:, None].expand(g, s, cp, m + 1),
                     3, counts[..., None])[..., 0]
    sensed = (v + sigma[:, None] * nz) > thr[:, None]
    truth = counts > m // 2
    cnt = (sensed.to(torch.int32) - truth.to(torch.int32)).sum(dim=1)
    bias = cnt.to(torch.float32) / k["s"]
    step = (torch.where(bias > k["thr"], -1, 0)
            + torch.where(bias < k["neg_thr"], 1, 0))
    new = torch.clamp(lv + step, 0, len(qsum) - 1).to(torch.int32)
    shape = tuple(lead) + (c,)
    return new[:, :c].reshape(shape), bias[:, :c].reshape(shape)


def _ladder(rng, n_levels):
    """A synthetic ladder of ``n_levels`` (charge sum, swing^2 sum) levels."""
    qsum = tuple(float(np.float32(q)) for q in rng.uniform(0.5, 2.5,
                                                           n_levels))
    swing = tuple(float(np.float32(w)) for w in rng.uniform(0.5, 3.0,
                                                            n_levels))
    return qsum, swing


#: M -> (const_charge_sum, const_swing_sq): MAJ3 opens a 0/1 constant pair
CONSTS = {3: (1.0, 2.0), 5: (0.0, 0.0), 7: (0.0, 0.0)}


@pytest.mark.parametrize("c", [4096, 1000, 77])
@pytest.mark.parametrize("n_levels", range(1, 9))
@pytest.mark.parametrize("m", [3, 5, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_schedule_equals_plain(seed, m, n_levels, c):
    """The kernel's schedule (voltage table, operand words, byte path at
    C = 77 and on unaligned pointers) equals ``calib_iter_plain`` bit for
    bit."""
    rng = np.random.default_rng([seed, m, n_levels, c])
    qsum, swing = _ladder(rng, n_levels)
    s, g = 24, 2
    bits = torch.from_numpy(rng.integers(0, 2, (g, s, m, c), dtype=np.uint8))
    noise = torch.from_numpy(rng.standard_normal((g, s, c)).astype(
        np.float32))
    levels = torch.from_numpy(rng.integers(0, n_levels, (g, c),
                                           dtype=np.int32))
    offs = torch.from_numpy((0.033 * rng.standard_normal((g, c))).astype(
        np.float32))
    cc, cs = CONSTS[m]
    args = (P, 3, qsum, swing, 0.02)
    want = calib_iter_plain(bits, noise, levels, offs, *args, m, cc, cs)
    for aligned in (True, False):
        got = _emulate_kernel(bits, noise, levels, offs, *args, m, cc, cs,
                              aligned=aligned)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[0] != levels).any() or n_levels == 1


def test_kernel_schedule_equals_jnp_oracle():
    """The emulated schedule on the main path's ladder equals the
    reference's eager oracle bit for bit."""
    ladder, bits, noise, levels, offs = _inputs(0)
    qsum, swing = ladder_tables(ladder, P)
    got = _emulate_kernel(torch.from_numpy(bits), torch.from_numpy(noise),
                          torch.from_numpy(levels), torch.from_numpy(offs),
                          P, ladder.n_fracs, qsum, swing, 0.0009, 5)
    want = j_calib_iter_ref(*_jax_args(bits, noise, levels, offs, ladder))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_plan_of_the_main_path():
    """16 subarrays of 65,536 columns, MAJ5: the vector path, four columns
    to a thread, 1,024 blocks of 256 with a 24 KB table each."""
    assert plan_launch(16, 5, 65536, True) == Plan(True, 256, 24576, 1024)


@pytest.mark.parametrize("c, aligned, vec", [
    (65536, True, True), (1000, True, True), (4096, False, False),
    (1001, True, False), (77, True, False), (2, True, False)])
def test_plan_vector_path_needs_alignment(c, aligned, vec):
    assert plan_launch(3, 5, c, aligned).vec is vec


@pytest.mark.parametrize("m, threads", [(1, 256), (5, 256), (11, 256),
                                        (12, 128), (23, 128), (24, 64),
                                        (95, 32), (255, 32)])
def test_plan_table_fits_shared_memory(m, threads):
    """The block shrinks until (M + 1) x 4 floats per thread fit the
    default 48 KB; past M = 95 it opts in to more, never past the card's
    per-block limit."""
    plan = plan_launch(1, m, 4096, True)
    assert plan.threads == threads
    assert plan.smem_bytes == (m + 1) * COLS * 4 * threads <= SMEM_MAX
    assert plan.smem_bytes <= SMEM_DEFAULT or threads == THREADS[-1]


@pytest.mark.parametrize("g, c", [(16, 65536), (3, 1001), (1, 1), (5, 77),
                                  (7, 4100)])
def test_plan_blocks_cover_the_grid_once(g, c):
    plan = plan_launch(g, 5, c, True)
    items = g * -(-c // COLS)
    assert (plan.blocks - 1) * plan.threads < items <= \
        plan.blocks * plan.threads


@pytest.mark.parametrize("m", [0, 256])
def test_plan_refuses_operand_counts_a_byte_cannot_hold(m):
    with pytest.raises(ValueError, match="operands"):
        plan_launch(1, m, 4096, True)
