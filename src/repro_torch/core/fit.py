"""One-time fit of the physics noise constants to the paper's silicon
(port of ``repro/core/fit.py``: the same numpy float64 operations on the
port's ``PhysicsParams`` and ``make_ladder``, so the fitted constants equal
the reference's).

The paper measures real SK Hynix DDR4 chips; we have a physics model with
five free constants (sigma_static, sigma_dynamic, sigma_frac, sigma_transfer,
frac_alpha).  This module fits them ONCE against four measured operating
points, all taken from the paper:

    ECR(B_{3,0,0}) = 46.6 %                       (Table I)
    ECR(T_{2,1,0}) =  3.3 %                       (Table I)
    ECR(T_{0,0,0}) = 20.9 %   <- backed out of Fig. 5's "T210 = 1.03x T000"
    ECR(T_{2,2,2}) = 24.4 %   <- backed out of Fig. 5's "T210 = 1.48x T222"

(The Fig. 5 back-outs divide the throughput ratios by the command-count
latency ratios 16/19 and 22/19 of the T_{x,y,z} Frac configurations.)

Everything else the paper reports — the 1.81x/1.88x/1.89x gains,
ADD/MUL absolute throughput, the Fig. 5 orderings at other configurations,
Fig. 6 — is a *prediction* of the fitted model.

The fit uses the smooth closed-form ECR expectation (ecr.expected_ecr_maj5's
per-trial failure model) integrated over the threshold-deviation distribution
on a grid, with nearest-ladder-level assignment; the Monte-Carlo pipeline then
validates the fitted constants end-to-end
(``python -m repro_torch.benchmarks.table1``).

Run:  PYTHONPATH=src python -m repro_torch.core.fit
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.pud.physics import PhysicsParams

from .offsets import make_ladder

N_TRIALS = 8192
TARGETS = {
    "B300": 0.466,
    "T210": 0.033,
    "T000": 0.209,
    "T222": 0.244,
}
INPUT_SWING_SQ = 5.0  # five full-swing operand rows


def _config_geometry(name: str, p: PhysicsParams):
    """(candidate offsets volts, n_fracs, sum_swing_sq) for a MAJ5 config."""
    if name.startswith("B"):
        x = int(name[1])
        off = np.array([0.5 * p.frac_alpha**x * p.cell_weight])
        swing = INPUT_SWING_SQ + 2.0 + p.frac_alpha ** (2 * x)
        return off, x, swing
    fc = tuple(int(c) for c in name[1:])
    ladder = make_ladder(fc, p)
    offs = np.asarray(ladder.offsets_units) * p.cell_weight
    swing = INPUT_SWING_SQ + sum(p.frac_alpha ** (2 * f) for f in fc)
    return offs, sum(fc), swing


_ERF = np.vectorize(__import__("math").erf)


def _phi(z):
    """Standard normal CDF (no scipy in this environment)."""
    return 0.5 * (1.0 + _ERF(np.asarray(z) / np.sqrt(2.0)))


def trial_fail_prob(residual, sigma_eff, margin):
    ncdf = _phi
    p_hi = ncdf(-(margin - residual) / sigma_eff)
    p_lo = ncdf(-(margin + residual) / sigma_eff)
    p_hi2 = ncdf(-(3 * margin - residual) / sigma_eff)
    p_lo2 = ncdf(-(3 * margin + residual) / sigma_eff)
    return (10 / 32) * (p_hi + p_lo) + (5 / 32) * (p_hi2 + p_lo2)


def expected_ecr(name: str, p: PhysicsParams, n_dev: int = 4001) -> float:
    """E[ECR] over dev ~ N(0, sigma_static), nearest-level calibration."""
    offs, n_fracs, swing = _config_geometry(name, p)
    dev = np.linspace(-6, 6, n_dev) * p.sigma_static
    w = np.exp(-0.5 * (dev / p.sigma_static) ** 2)
    w /= w.sum()
    resid = dev[:, None] - offs[None, :]
    best = resid[np.arange(n_dev), np.abs(resid).argmin(axis=1)]
    sig = np.sqrt(
        p.sigma_dynamic**2
        + p.sigma_frac**2 * n_fracs
        + p.sigma_transfer**2 * swing
    )
    pfail = trial_fail_prob(best, sig, p.maj_margin)
    return float((w * (1.0 - (1.0 - pfail) ** N_TRIALS)).sum())


# Paper Fig. 5 shows T_{2,1,0} as the globally OPTIMAL configuration.  If the
# x=1 point of that figure is T100, the paper's numbers imply
# ECR(T100) >= ~10% (else T100's 17-ACT latency would beat T210's 19).  An
# optional hinge (ordering_weight > 0) imposes throughput(T210) >= every
# other T config.  FINDING: this hinge
# is UNSATISFIABLE jointly with the four ECR targets under any column-global
# noise model — T000 = 20.9% forces central-gap failures at residual ~= the
# MAJ5 margin, which bounds the granularity cutoff m - z*sigma_d from below,
# and T100's 0.5*alpha central level (0.013 V) then always clears it.  The
# silicon must have a failure mode outside this model (most plausibly the
# wide per-cell spread of intermediate charge states that FracDRAM reports,
# hitting T100's single fine level hardest).  We therefore ship the 4-target
# fit (ordering_weight = 0) and report the T100 ordering as a known
# model-vs-silicon deviation rather than distorting the validated Table-I
# operating points.
ORDER_VS_T210 = ("T100", "T110", "T111", "T211", "T221", "T000", "T222")


def _throughput_au(name: str, ecr: float) -> float:
    n_fracs = sum(int(c) for c in name[1:4])
    return (1.0 - ecr) / (16 + n_fracs)


def loss(p: PhysicsParams, ordering_weight: float = 0.0) -> float:
    err = 0.0
    for name, tgt in TARGETS.items():
        err += ((expected_ecr(name, p) - tgt) / max(tgt, 0.05)) ** 2
    if ordering_weight > 0.0:
        tp210 = _throughput_au("T210", expected_ecr("T210", p))
        for name in ORDER_VS_T210:
            tp = _throughput_au(name, expected_ecr(name, p))
            # hinge: any config beating T210 (with 3% slack) is penalized
            err += ordering_weight * max(0.0, tp / tp210 - 1.03) ** 2
    return err


def fit(verbose: bool = True, ordering_weight: float = 0.0) -> PhysicsParams:
    """Coordinate-descent grid refinement over the five constants."""
    best = PhysicsParams(
        sigma_static=0.036, sigma_dynamic=0.0008, sigma_frac=0.0006,
        sigma_transfer=0.0004, frac_alpha=0.47)
    best_loss = loss(best, ordering_weight)
    grids = {
        "sigma_static": np.linspace(0.024, 0.048, 25),
        "frac_alpha": np.linspace(0.34, 0.60, 27),
        "sigma_dynamic": np.linspace(0.0002, 0.0080, 27),
        "sigma_frac": np.linspace(0.0, 0.0030, 16),
        "sigma_transfer": np.linspace(0.0, 0.0020, 11),
    }
    for sweep in range(6):
        improved = False
        for field, grid in grids.items():
            for v in grid:
                cand = dataclasses.replace(best, **{field: float(v)})
                l = loss(cand, ordering_weight)
                if l < best_loss - 1e-9:
                    best, best_loss, improved = cand, l, True
        # refine grids around current best
        for field in grids:
            c = getattr(best, field)
            span = (grids[field][-1] - grids[field][0]) / 4
            grids[field] = np.linspace(max(0.0, c - span), c + span, 17)
        if verbose:
            print(f"sweep {sweep}: loss={best_loss:.5f} "
                  + " ".join(f"{f}={getattr(best, f):.5f}" for f in grids))
        if not improved:
            break
    return best


def main() -> None:
    p = fit()
    print("\nFitted constants:")
    for f in ("sigma_static", "sigma_dynamic", "sigma_frac",
              "sigma_transfer", "frac_alpha"):
        print(f"  {f} = {getattr(p, f):.6f}")
    print("\nPredicted vs target ECR:")
    for name, tgt in TARGETS.items():
        print(f"  {name}: model={expected_ecr(name, p):.4f} target={tgt:.4f}")
    for name in ("T100", "T110", "T211", "T221", "T321", "B000", "B600"):
        print(f"  {name}: model={expected_ecr(name, p):.4f} (prediction)")

    # The Fig.-5 ordering experiment (see module comment at ORDER_VS_T210):
    # rerun with the hinge active and show the residual tension.
    print("\nOrdering-hinge experiment (throughput(T210) >= all T configs):")
    ph = fit(verbose=False, ordering_weight=25.0)
    print("  hinged fit:", {f: round(getattr(ph, f), 5) for f in (
        "sigma_static", "sigma_dynamic", "frac_alpha")})
    tp210 = _throughput_au("T210", expected_ecr("T210", ph))
    for name in ORDER_VS_T210:
        r = _throughput_au(name, expected_ecr(name, ph)) / tp210
        flag = "VIOLATED" if r > 1.03 else "ok"
        print(f"  tput({name})/tput(T210) = {r:.3f}  [{flag}]")
    print("  -> hinge remains violated at the optimum: the four ECR targets "
          "and the T100 ordering\n     are jointly unsatisfiable in a "
          "column-global noise model.")


if __name__ == "__main__":
    main()
