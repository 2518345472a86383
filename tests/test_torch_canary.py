"""Parity of the port's canary primitives (``repro_torch.core.canary``) with
the JAX package's (``repro.core.canary``).

Canary reservation and the reservation fingerprint are numpy logic: held
equal to the reference's exactly.  ``probe_ecr`` draws its trials from a
generator where the reference uses a key, so it is held exactly where the
draws cannot matter: at zero sensing noise with 1,024 trials every one of
the 32 MAJ5 input patterns reaches every column (a column misses one with
probability ~1e-13), so the error masks are the deterministic set of
columns that err on some pattern.  ``drifted_offsets`` is held exactly
where no leg is drawn, and statistically otherwise: each leg's shift has
standard deviation ``sigma * scale`` within 4 standard errors, and the two
legs are uncorrelated within 4 standard errors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import canary as jcanary  # noqa: E402
from repro.core.fleet import fleet_calib_charges as j_charges  # noqa: E402
from repro.core.offsets import make_ladder as j_ladder  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro_torch.core import canary  # noqa: E402
from repro_torch.core.ecr import measure_ecr_fleet  # noqa: E402
from repro_torch.core.fleet import fleet_calib_charges  # noqa: E402
from repro_torch.core.offsets import make_ladder  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402

ZERO_SIGMA = dict(sigma_dynamic=0.0, sigma_frac=0.0, sigma_transfer=0.0)


def _masks(seed, g, c, p):
    return np.random.default_rng(seed).random((g, c)) < p


@pytest.mark.parametrize("seed,g,c,p,n", [(5, 3, 256, 0.3, 8),
                                          (1, 16, 1024, 0.05, 16),
                                          (2, 4, 300, 0.9, 7),
                                          (3, 2, 64, 0.0, 64)])
def test_reservation_and_fingerprint_equal_reference(seed, g, c, p, n):
    masks = _masks(seed, g, c, p)
    cols = canary.reserve_canaries(masks, n)
    want = jcanary.reserve_canaries(masks, n)
    assert cols.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(cols, want)
    np.testing.assert_array_equal(
        canary.reserve_canaries(torch.from_numpy(masks), n), want)
    cs = canary.CanarySet(cols=cols, n_cols=c)
    jcs = jcanary.CanarySet(cols=want, n_cols=c)
    np.testing.assert_array_equal(cs.mask(), jcs.mask())
    assert cs.fingerprint() == jcs.fingerprint()
    assert cs.n_per_subarray == jcs.n_per_subarray == n
    assert not (cs.mask() & masks).any()


def test_insufficient_columns_raise_like_reference():
    masks = np.ones((2, 32), bool)
    masks[1, :3] = False
    with pytest.raises(ValueError) as port:
        canary.reserve_canaries(masks, 4)
    with pytest.raises(ValueError) as ref:
        jcanary.reserve_canaries(masks, 4)
    assert str(port.value) == str(ref.value)
    assert "subarray 0: only 0 error-free" in str(port.value)


def _fleet(seed, g, c, physics):
    """Numpy-drawn offsets [G, C] and random ladder levels as charges."""
    rng = np.random.default_rng(seed)
    offs = (0.033 * rng.standard_normal((g, c))).astype(np.float32)
    ladder = make_ladder((2, 1, 0), physics)
    levels = rng.integers(0, ladder.n_levels, (g, c)).astype(np.int32)
    return offs, levels, ladder


def test_probe_cols_equals_measure_ecr_fleet_on_gathered_inputs():
    p = PhysicsParams()
    offs, levels, ladder = _fleet(4, 3, 512, p)
    offs = torch.from_numpy(offs)
    charges = fleet_calib_charges(ladder, torch.from_numpy(levels), p)
    cols = canary.reserve_canaries(_masks(9, 3, 512, 0.2), 16)
    ecr, masks = canary.probe_ecr(21, offs, charges, p, ladder.n_fracs,
                                  cols=cols, n_trials=64)
    idx = torch.from_numpy(cols).long()
    want_e, want_m = measure_ecr_fleet(
        21, torch.gather(offs, 1, idx),
        torch.stack([charges[g][:, idx[g]] for g in range(3)]), p,
        ladder.n_fracs, n_trials=64, chunk=64)
    assert masks.shape == (3, 16) and ecr.dtype == torch.float32
    assert torch.equal(masks, want_m) and torch.equal(ecr, want_e)
    # cols=None measures every column
    e_all, m_all = canary.probe_ecr(21, offs, charges, p, ladder.n_fracs,
                                    n_trials=64)
    assert m_all.shape == (3, 512)
    assert torch.equal(e_all, measure_ecr_fleet(
        21, offs, charges, p, ladder.n_fracs, n_trials=64, chunk=64)[0])


@pytest.mark.parametrize("with_cols", [True, False])
def test_probe_masks_equal_reference_at_zero_sensing_noise(with_cols):
    p, jp = PhysicsParams(**ZERO_SIGMA), JPhys(**ZERO_SIGMA)
    offs, levels, ladder = _fleet(6, 4, 384, p)
    cols = (canary.reserve_canaries(_masks(8, 4, 384, 0.1), 16)
            if with_cols else None)
    ecr, masks = canary.probe_ecr(
        3, torch.from_numpy(offs),
        fleet_calib_charges(ladder, torch.from_numpy(levels), p), p,
        ladder.n_fracs, cols=cols, n_trials=1024)
    jl = j_ladder((2, 1, 0), jp)
    j_ecr, j_masks = jcanary.probe_ecr(
        jax.random.key(3), jnp.asarray(offs),
        j_charges(jl, jnp.asarray(levels), jp), jp, jl.n_fracs, cols=cols,
        n_trials=1024)
    j_masks = np.asarray(j_masks)
    assert 0 < j_masks.mean() < 1           # some columns err, some do not
    np.testing.assert_array_equal(masks.numpy(), j_masks)
    np.testing.assert_array_equal(ecr.numpy(), np.asarray(j_ecr))


def test_drifted_offsets_identity_with_both_legs_off():
    p = PhysicsParams()
    offs = torch.from_numpy(_fleet(1, 2, 100, p)[0])
    assert torch.equal(canary.drifted_offsets(5, offs, p), offs)
    assert torch.equal(canary.drifted_offsets(5, offs[0], p), offs[0])
    # at the nominal temperature the temperature leg has zero scale
    assert torch.equal(canary.drifted_offsets(
        5, offs, p, temp_c=p.temp_nominal_c), offs)


N_DRAW = 200_000


@pytest.mark.parametrize("leg", [dict(temp_c=100.0), dict(temp_c=0.0),
                                 dict(days=7.0), dict(days=0.25)])
def test_each_leg_has_its_scale(leg):
    p = PhysicsParams()
    base = torch.zeros(N_DRAW)
    shift = canary.drifted_offsets(11, base, p, **leg)
    if "temp_c" in leg:
        want = p.sigma_temp_drift * abs(leg["temp_c"] - p.temp_nominal_c)
    else:
        want = p.sigma_time_drift * np.sqrt(leg["days"])
    std = float(shift.double().std())
    # the standard error of a sample std is sigma / sqrt(2 n)
    assert abs(std - want) <= 4 * want / np.sqrt(2 * N_DRAW)
    assert abs(float(shift.double().mean())) <= 4 * want / np.sqrt(N_DRAW)
    # deterministic in the seed, another seed another draw
    assert torch.equal(shift, canary.drifted_offsets(11, base, p, **leg))
    assert not torch.equal(shift, canary.drifted_offsets(12, base, p, **leg))


def test_legs_are_independent_streams():
    p = PhysicsParams()
    base = torch.zeros(N_DRAW)
    t = canary.drifted_offsets(11, base, p, temp_c=80.0)
    d = canary.drifted_offsets(11, base, p, days=3.0)
    both = canary.drifted_offsets(11, base, p, temp_c=80.0, days=3.0)
    # the combined shift is the two legs' sum (each from its own stream)
    torch.testing.assert_close(both, t + d, rtol=0, atol=1e-9)
    r = float(np.corrcoef(t.numpy(), d.numpy())[0, 1])
    assert abs(r) <= 4 / np.sqrt(N_DRAW)
