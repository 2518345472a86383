"""Parity of the port's partial recalibration with the JAX package's.

``core/fleet.recalibrate_subarrays`` re-runs Algorithm 1 on a few
subarrays, each from its own stream.  The reference's streams are JAX keys
(``subarray_key(key, g)`` -> ``split(n_iterations)`` -> bernoulli /
normal draws) and the port's are ``torch.Generator``s, so the parity test
feeds the port's iteration loop (``iterate_calibration``) the JAX-drawn
draws of the reference's protocol.  The levels must equal the reference's
eager oracle (``kernels/ref.calib_iter_ref`` run op by op) exactly, and
the reference's jitted ``recalibrate_subarrays(method="reference")``
everywhere but the columns where that jitted path disagrees with its own
eager oracle (under ``jit`` the bitline division becomes a multiply by the
reciprocal, one ulp off, which flips a sensed bit on a threshold tie);
those columns are counted exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.core.fleet import ladder_tables as j_tables  # noqa: E402
from repro.core.fleet import manufacture_fleet as j_manufacture  # noqa: E402
from repro.core.fleet import recalibrate_subarrays as j_recal  # noqa: E402
from repro.core.fleet import subarray_key as j_subarray_key  # noqa: E402
from repro.core.offsets import neutral_level  # noqa: E402
from repro.kernels.ref import calib_iter_ref as j_calib_iter  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import (FleetConfig, iterate_calibration,  # noqa: E402
                                    manufacture_fleet, recalibrate_subarrays,
                                    subarray_key)
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402
from repro_torch.runtime.calib_cache import table_key  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

P, JP = PhysicsParams(), JPhys()
GRID = dict(n_channels=1, n_banks=2, n_subarrays=4, n_cols=512)
CAL = dict(n_iterations=12, n_samples=256)
SUB = (3, 5)


def _jax_draws(key, subarrays, cal):
    """The reference's per-subarray draws, iteration by iteration, stacked
    over ``subarrays``: [(bits [k, S, 5, C] uint8, noise [k, S, C])]."""
    c = GRID["n_cols"]
    per_sub = []
    for g in subarrays:
        its = []
        for it_key in jax.random.split(j_subarray_key(key, g),
                                       cal.n_iterations):
            k_in, k_noise = jax.random.split(it_key)
            bits = jax.random.bernoulli(k_in, 0.5,
                                        (1, cal.n_samples, 5, c))
            noise = jax.random.normal(k_noise, (1, cal.n_samples, c),
                                      jnp.float32)
            its.append((np.asarray(bits[0], np.uint8),
                        np.asarray(noise[0])))
        per_sub.append(its)
    return [(np.stack([s[i][0] for s in per_sub]),
             np.stack([s[i][1] for s in per_sub]))
            for i in range(cal.n_iterations)]


def _eager_oracle(draws, offs, ladder):
    """The reference's ``calib_iter_ref`` op by op (no jit) on the draws."""
    qsum, swing = j_tables(ladder, JP)
    levels = np.full(offs.shape, neutral_level(ladder), np.int32)
    for bits, noise in draws:
        for i in range(offs.shape[0]):
            lv, _ = j_calib_iter(jnp.asarray(bits[i], jnp.float32),
                                 jnp.asarray(noise[i]),
                                 jnp.asarray(levels[i]),
                                 jnp.asarray(offs[i]), JP, ladder.n_fracs,
                                 qsum, swing, 0.0009, 5)
            levels[i] = np.asarray(lv)
    return levels


@pytest.mark.parametrize("seed, n_ties", [(4, 0), (9, 0)])
@pytest.mark.parametrize("method", ["reference", "fused"])
def test_levels_on_jax_draws_equal_reference(seed, n_ties, method):
    """Bit-exact against the eager oracle; against the jitted reference
    everywhere but ``n_ties`` counted columns."""
    jcfg, jcal = JFleet(**GRID), JCal(**CAL)
    key = jax.random.key(seed)
    offsets = np.asarray(j_manufacture(key, jcfg, JP))
    want = np.asarray(j_recal(key, jnp.asarray(offsets), SUB, jcfg, JP,
                              jcal, method="reference"))
    draws = _jax_draws(key, SUB, jcal)
    offs = offsets[list(SUB)]
    ladder = FleetConfig(**GRID).ladder(P)
    levels, hist = iterate_calibration(
        ((torch.from_numpy(b), torch.from_numpy(n)) for b, n in draws),
        torch.from_numpy(offs), ladder, P, CalibrationConfig(**CAL), method)
    eager = _eager_oracle(draws, offs, ladder)
    np.testing.assert_array_equal(levels.numpy(), eager)
    agree = eager == want
    assert int((~agree).sum()) == n_ties
    np.testing.assert_array_equal(levels.numpy()[agree], want[agree])
    assert hist.shape == (CAL["n_iterations"],)
    assert (levels.numpy() != neutral_level(ladder)).any()


def _port_offsets(seed=1):
    return manufacture_fleet(seed, FleetConfig(**GRID), P, "cpu")


@pytest.mark.parametrize("method", ["fused", "reference", "per_subarray"])
def test_batching_independent(method):
    """{3} then {5} gives the rows of one {3, 5} pass (and the order in
    which subarrays are given does not matter)."""
    cfg, cal, offs = FleetConfig(**GRID), CalibrationConfig(**CAL), \
        _port_offsets()
    joint = recalibrate_subarrays(7, offs, [5, 3], cfg, P, cal,
                                  method=method)
    apart = torch.cat([recalibrate_subarrays(7, offs, [g], cfg, P, cal,
                                             method=method) for g in SUB])
    assert joint.shape == (2, GRID["n_cols"]) and joint.dtype == torch.int32
    assert torch.equal(joint, apart)


def test_fused_equals_reference_and_streams_are_per_subarray():
    cfg, cal, offs = FleetConfig(**GRID), CalibrationConfig(**CAL), \
        _port_offsets()
    fused = recalibrate_subarrays(7, offs, SUB, cfg, P, cal)
    assert torch.equal(fused, recalibrate_subarrays(
        7, offs, SUB, cfg, P, cal, method="reference"))
    # subarray g's stream is subarray_key(seed, g): another seed, or the
    # same offsets under another index, draws differently
    assert not torch.equal(fused, recalibrate_subarrays(
        8, offs, SUB, cfg, P, cal))
    g1 = subarray_key(7, 3)
    assert torch.equal(torch.randint(0, 9, (16,), generator=g1),
                       torch.randint(0, 9, (16,), generator=subarray_key(
                           7, 3)))
    with pytest.raises(ValueError, match="not in"):
        recalibrate_subarrays(7, offs, SUB, cfg, P, cal, method="pallas")


def test_per_subarray_equals_reference_at_zero_sigma():
    """Without sensing noise the single-subarray Algorithm 1 and the block
    loop sense the same bits from the same stream."""
    p0 = dataclasses.replace(P, sigma_dynamic=0.0, sigma_frac=0.0,
                             sigma_transfer=0.0)
    cfg, cal, offs = FleetConfig(**GRID), CalibrationConfig(**CAL), \
        _port_offsets()
    ref = recalibrate_subarrays(7, offs, SUB, cfg, p0, cal,
                                method="reference")
    assert torch.equal(ref, recalibrate_subarrays(
        7, offs, SUB, cfg, p0, cal, method="per_subarray"))


# ---------------------------------------------------------------------------
# The session merge
# ---------------------------------------------------------------------------

SESSION_GRID = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=512)


def _session(tmp_path):
    return PUDSession.open(
        "qwen3-1.7b", grid=FleetConfig(**SESSION_GRID), cache_dir=tmp_path,
        device_id="drifty", calib=CalibrationConfig(n_iterations=8,
                                                    n_samples=128),
        seed=2, n_trials_ecr=256, device="cpu")


def test_session_merge_keeps_other_rows_and_drops_placements(tmp_path):
    s = _session(tmp_path)
    with pytest.raises(RuntimeError, match="calibrate"):
        s.recalibrate_subarrays([3], _port_offsets())
    st0 = s.calibrate()
    model = get("qwen3-1.7b").make_smoke()
    s.pack(init_params(model.param_defs(), 0, "cpu"), name="persisted")
    entry = tmp_path / "drifty" / table_key(s.fleet_cfg, s.physics)
    assert list((entry / "placements").glob("*.npz"))
    age = s.calibration_age()
    assert age["age_days"] >= 0.0
    assert age["assumed_temp_c"] == s.physics.temp_nominal_c
    assert age["params_fingerprint"] is not None
    levels0, ecr0, masks0 = (st0.levels.clone(), st0.ecr.clone(),
                             st0.masks.clone())

    # drift subarray 3's offsets by half a sigma_static
    offs = manufacture_fleet(s.seed, s.fleet_cfg, s.physics, "cpu")
    gen = torch.Generator().manual_seed(11)
    offs[3] += 0.5 * s.physics.sigma_static * torch.randn(
        offs.shape[1], generator=gen)
    st1 = s.recalibrate_subarrays([3], offs, assumed_temp_c=70.0)
    assert s.calibration is st1 and not st1.cache_hit
    keep = [g for g in range(8) if g != 3]
    assert torch.equal(st1.levels[keep], levels0[keep])
    assert torch.equal(st1.ecr[keep], ecr0[keep])
    assert torch.equal(st1.masks[keep], masks0[keep])
    assert torch.equal(st1.levels[3], recalibrate_subarrays(
        s.seed, offs, [3], s.fleet_cfg, s.physics, s.calib_cfg)[0])
    assert not torch.equal(st1.levels[3], levels0[3])
    assert float(st1.ecr[3]) == float(st1.masks[3].float().mean())
    # the merged table is persisted with the recovery metadata ...
    table = s.cache.load("drifty", s.fleet_cfg, s.physics)
    assert table.metadata["recalibrated_subarrays"] == [3]
    assert table.metadata["method"] == "fused"
    assert table.assumed_temp_c == 70.0
    np.testing.assert_array_equal(table.levels, st1.levels.numpy())
    np.testing.assert_array_equal(table.masks, st1.masks.numpy())
    # ... and the save dropped the entry's stale placements
    assert not list((entry / "placements").glob("*.npz"))
    assert s.calibration_age()["assumed_temp_c"] == 70.0


def test_calibration_age_without_cache_is_none():
    s = PUDSession.open(grid=FleetConfig(**SESSION_GRID), device="cpu")
    assert s.calibration_age() is None
