"""Parity of the port's reliability sweep and drift simulator
(``repro_torch.core.reliability``) with the JAX package's.

The two packages draw their manufactured offsets, calibration samples,
drift and trial patterns from different random streams, so the sweep is
compared statistically: at each condition the ECR and new ECR of the port
and of the reference are two independent estimates of one column
probability over ``N_COLS`` columns, and their difference must lie within
4 binomial sigmas, ``4 * sqrt(2 p (1 - p) / N_COLS)`` at the pooled ``p``
(floored at one column so an all-zero point still has a scale).  The
drift simulator is held exactly: epoch 0 is ``manufacture_fleet``, rows
outside ``subarrays`` keep their base offsets, and an epoch is stable.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.core.reliability import reliability_sweep as j_sweep  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig, manufacture_fleet  # noqa: E402
from repro_torch.core.reliability import (DriftSimulator,  # noqa: E402
                                          ReliabilityPoint,
                                          reliability_sweep)
from repro_torch.pud.physics import PhysicsParams  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

N_COLS, N_TRIALS = 2048, 512
TEMPS, DAYS = (40.0, 100.0), (1.0, 7.0)


def _tol(a: float, b: float) -> float:
    p = min(max((a + b) / 2, 1 / N_COLS), 1 - 1 / N_COLS)
    return 4 * np.sqrt(2 * p * (1 - p) / N_COLS)


@pytest.fixture(scope="module")
def sweeps():
    port = reliability_sweep(0, "T210", temps_c=TEMPS, days=DAYS,
                             n_cols=N_COLS, n_trials=N_TRIALS, device="cpu")
    ref = j_sweep(jax.random.key(0), "T210", temps_c=TEMPS, days=DAYS,
                  n_cols=N_COLS, n_trials=N_TRIALS)
    return port, ref


@pytest.mark.parametrize("leg", [0, 1])
def test_sweep_within_binomial_of_reference(sweeps, leg):
    port, ref = sweeps[0][leg], sweeps[1][leg]
    assert [p.condition for p in port] == [p.condition for p in ref] == \
        list(TEMPS if leg == 0 else DAYS)
    for p, r in zip(port, ref):
        assert isinstance(p, ReliabilityPoint)
        assert abs(p.ecr - r.ecr) <= _tol(p.ecr, r.ecr), (p, r)
        assert abs(p.new_ecr - r.new_ecr) <= _tol(p.new_ecr, r.new_ecr), \
            (p, r)
        assert 0 <= p.new_ecr <= p.ecr < 0.2


def test_sweep_is_deterministic_in_its_seed():
    kw = dict(temps_c=(60.0,), days=(2.0,), n_cols=256, n_trials=64,
              calib_config=CalibrationConfig(n_iterations=4, n_samples=64),
              device="cpu")
    a, b = reliability_sweep(3, **kw), reliability_sweep(3, **kw)
    assert a == b


GRID = FleetConfig(n_channels=1, n_banks=2, n_subarrays=3, n_cols=512)


def _session():
    return PUDSession.open(grid=GRID, seed=7, device="cpu")


def test_simulator_epoch0_is_the_manufactured_fleet():
    s = _session()
    sim = DriftSimulator.for_session(s)
    base = manufacture_fleet(s.seed, GRID, s.physics, "cpu")
    assert not sim.drifted and torch.equal(sim.sense_offsets(), base)
    sim.advance(days=0.0)                  # an epoch with no drift
    assert not sim.drifted and torch.equal(sim.sense_offsets(), base)


def test_simulator_moves_only_the_named_rows_and_is_epoch_stable():
    s = _session()
    sim = DriftSimulator.for_session(s)
    base = sim.sense_offsets().clone()
    sim.advance(temp_c=3000.0, subarrays=[1, 4])
    offs = sim.sense_offsets()
    assert torch.equal(offs, sim.sense_offsets())          # stable
    for g in range(GRID.n_subarrays_total):
        moved = not torch.equal(offs[g], base[g])
        assert moved == (g in (1, 4)), g
    # the next epoch redraws; the whole grid when no rows are named
    sim.advance(days=2.0)
    assert sim.days == 2.0 and sim.temp_c == 3000.0
    again = sim.sense_offsets()
    assert not torch.equal(again[1], offs[1])
    assert all(not torch.equal(again[g], base[g])
               for g in range(GRID.n_subarrays_total))
    # back at nominal conditions with no elapsed days the base returns
    sim2 = DriftSimulator.for_session(s)
    sim2.advance(temp_c=s.physics.temp_nominal_c)
    assert torch.equal(sim2.sense_offsets(), base)


def test_simulator_drift_scale_follows_the_physics():
    s = _session()
    sim = DriftSimulator.for_session(s)
    sim.advance(temp_c=150.0)
    shift = (sim.sense_offsets() - sim.base).double()
    want = PhysicsParams().sigma_temp_drift * 100.0
    n = shift.numel()
    assert abs(float(shift.std()) - want) <= 4 * want / np.sqrt(2 * n)
