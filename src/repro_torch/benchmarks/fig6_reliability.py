"""Paper Fig. 6: reliability of a fixed T_{2,1,0} calibration under
temperature (40-100 C) and time (1 week) drift (port of
``benchmarks/fig6_reliability.py``).

The metric is *new ECR*: columns error-free at calibration time that err
under the drifted condition.  Paper: < 0.14 % across temperature, < 0.27 %
across one week.  The sweep (``core/reliability.reliability_sweep``)
re-measures every column with a fresh finite trial campaign, so the
nominal point itself reads the campaign's churn floor (``core/canary``).

    python -m repro_torch.benchmarks.fig6_reliability [--full] [--n-cols N]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.core.reliability import reliability_sweep

from .common import emit, parse_scale, timed


def run(scale, seed: int = 11, device=None, **kw
        ) -> tuple[list[dict], list[dict]]:
    """(temperature rows, time rows); ``kw`` passes through to the sweep
    (``temps_c``, ``days``, ``calib_config``)."""
    with timed("fig6 sweep"):
        temp_pts, time_pts = reliability_sweep(
            seed, "T210", n_cols=scale.n_cols,
            n_trials=scale.n_trials_maj5, device=device, **kw)
    temps = [{"temp_c": p.condition, "ecr_pct": 100 * p.ecr,
              "new_ecr_pct": 100 * p.new_ecr} for p in temp_pts]
    times = [{"days": p.condition, "ecr_pct": 100 * p.ecr,
              "new_ecr_pct": 100 * p.new_ecr} for p in time_pts]
    return temps, times


def report(scale, device=None) -> None:
    temps, times = run(scale, device=device)
    emit("fig6_temperature", temps)
    emit("fig6_time", times)
    max_t = max(r["new_ecr_pct"] for r in temps)
    max_d = max(r["new_ecr_pct"] for r in times)
    print("Fig. 6 validation vs paper:")
    print(f"  new ECR over 40-100C: max {max_t:.3f}%  (paper < 0.14%)")
    print(f"  new ECR over 1 week:  max {max_d:.3f}%  (paper < 0.27%)")


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
