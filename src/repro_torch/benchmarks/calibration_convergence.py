"""Algorithm 1 convergence: per-iteration mean |bias| and end-state ECR as a
function of the iteration budget (port of
``benchmarks/calibration_convergence.py``; the paper uses 20 iterations x
512 samples).

Shows (a) the bias walk converges well inside the paper's budget, and (b)
the marginal ECR value of extra iterations (diminishing after ~10).

    python -m repro_torch.benchmarks.calibration_convergence [--full]
        [--n-cols N] [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.core.calibrate import CalibrationConfig, calibration_history
from repro_torch.core.ecr import measure_ecr_maj5
from repro_torch.core.offsets import levels_to_charges, make_ladder
from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.pud.physics import PhysicsParams

from .common import emit, parse_scale, timed

BUDGETS = (1, 2, 5, 10, 15, 20, 30)


def run(scale, seed: int = 3, device=None, budgets=BUDGETS,
        n_trials: int = 2048) -> list[dict]:
    device = resolve_device(device)
    params = PhysicsParams()
    ladder = make_ladder((2, 1, 0), params)
    n = min(scale.n_cols, 16384)
    sense = torch.tensor(params.sigma_static, dtype=torch.float32,
                         device=device) * torch.randn(
        n, generator=generator(seed, "manufacture", device=device),
        device=device, dtype=torch.float32)

    rows = []
    with timed("convergence history"):
        # every budget restarts from the same streams, so a budget's levels
        # are the first k iterations of any longer run (Algorithm 1's
        # prefix property)
        for iters in budgets:
            cfg = CalibrationConfig(n_iterations=iters)
            levels, hist = calibration_history(
                generator(seed, "calibrate", device=device), sense, ladder,
                params, cfg)
            ecr, _ = measure_ecr_maj5(
                generator(seed, "ecr", device=device), sense,
                levels_to_charges(ladder, levels, params), params,
                ladder.n_fracs, n_trials=n_trials)
            rows.append({
                "iterations": iters,
                "mean_abs_bias_last": hist[-1],
                "ecr_pct": 100 * ecr,
            })
    return rows


def report(scale, device=None) -> None:
    rows = run(scale, device=device)
    emit("calibration_convergence", rows,
         header="ECR after k Algorithm-1 iterations (paper budget: 20)")
    e20 = next(r for r in rows if r["iterations"] == 20)["ecr_pct"]
    e30 = next(r for r in rows if r["iterations"] == 30)["ecr_pct"]
    print("Convergence: ECR(20 iters) = "
          f"{e20:.2f}%, ECR(30 iters) = {e30:.2f}% "
          f"(paper budget of 20 captures the gain)")


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
