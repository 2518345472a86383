"""Parity of the port's noise-constant fit (``core/fit.py``) with the JAX
package's.

Both fits are the same float64 numpy operations on equal ``PhysicsParams``
and ladders, so the expected ECRs are held exactly equal and the fitted
constants to 1e-12 relative (exact equality is expected).  Each package's
fit runs once per module (about 6 s each on a CPU).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.core import fit as jfit  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro_torch.core import fit  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402

PREDICTIONS = ("T100", "T110", "T211", "T221", "T321", "B000", "B600")
FIELDS = ("sigma_static", "sigma_dynamic", "sigma_frac", "sigma_transfer",
          "frac_alpha")


@pytest.fixture(scope="module")
def fits():
    return fit.fit(verbose=False), jfit.fit(verbose=False)


def test_targets_and_ordering_match():
    assert fit.TARGETS == jfit.TARGETS
    assert fit.ORDER_VS_T210 == jfit.ORDER_VS_T210
    assert fit.N_TRIALS == jfit.N_TRIALS


@pytest.mark.parametrize("name", tuple(jfit.TARGETS) + PREDICTIONS)
def test_expected_ecr_equals_reference(name):
    assert fit.expected_ecr(name, PhysicsParams()) == \
        jfit.expected_ecr(name, JPhys())


def test_trial_fail_prob_and_loss_equal_reference():
    import numpy as np
    r = np.linspace(-0.05, 0.05, 101)
    np.testing.assert_array_equal(fit.trial_fail_prob(r, 0.002, 0.05),
                                  jfit.trial_fail_prob(r, 0.002, 0.05))
    p = PhysicsParams(sigma_static=0.03, frac_alpha=0.45)
    jp = JPhys(sigma_static=0.03, frac_alpha=0.45)
    assert fit.loss(p) == jfit.loss(jp)
    assert fit.loss(p, 25.0) == jfit.loss(jp, 25.0)


def test_fitted_constants_equal_reference(fits):
    port, ref = fits
    for f in FIELDS:
        assert getattr(port, f) == pytest.approx(getattr(ref, f),
                                                 rel=1e-12, abs=0), f
    # everything the fit does not touch keeps the defaults
    assert dataclasses.asdict(port).keys() == dataclasses.asdict(ref).keys()
    for name in jfit.TARGETS:
        assert fit.expected_ecr(name, port) == pytest.approx(
            jfit.expected_ecr(name, ref), rel=1e-12, abs=0)


def test_fit_lands_near_the_paper_targets(fits):
    port, _ = fits
    for name, target in fit.TARGETS.items():
        assert abs(fit.expected_ecr(name, port) - target) < 0.25 * target
