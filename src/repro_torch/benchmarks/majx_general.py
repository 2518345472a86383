"""Beyond the paper: PUDTune generalized to MAJ3 / MAJ5 / MAJ7 (paper Sec.
III-D; port of ``benchmarks/majx_general.py``), quantifying how the gain
scales with the number of free rows.

8-row SiMRA row budget:
  MAJ3: 3 operands + 0/1 constant pair + 3 calibration rows  (2^3-level ladder)
  MAJ5: 5 operands + 3 calibration rows                      (2^3-level ladder)
  MAJ7: 7 operands + 1 calibration row                       (2-level ladder)

With one free row MAJ7's ladder is coarse only, so calibration recovers far
fewer columns: why the paper's full-adder mapping leans on MAJ5 / MAJ3.

    python -m repro_torch.benchmarks.majx_general [--full] [--n-cols N]
        [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.core.calibrate import CalibrationConfig, identify_calibration
from repro_torch.core.ecr import measure_ecr_majx
from repro_torch.core.offsets import levels_to_charges, make_ladder
from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.pud.physics import NEUTRAL, PhysicsParams

from .common import emit, parse_scale, timed

# (n_inputs, calibration frac counts, const rows as (charge_sum, swing_sq))
CONFIGS = {
    3: dict(fc=(2, 1, 0), const=(1.0, 2.0)),   # 0/1 pair
    5: dict(fc=(2, 1, 0), const=(0.0, 0.0)),
    7: dict(fc=(1,), const=(0.0, 0.0)),        # one calibration row
}


def _neutral_charges(fc, n_cols: int, params: PhysicsParams,
                     device) -> torch.Tensor:
    """Uncalibrated baseline for this row budget, as the paper's B_{3,0,0}:
    one near-neutral row (Frac'd 3x) plus 0/1 constant pairs for any
    remaining rows."""
    rows = [NEUTRAL + 0.5 * params.frac_alpha ** 3]
    for i in range(1, len(fc)):
        rows.append(0.0 if i % 2 else 1.0)
    col = torch.tensor(rows, dtype=torch.float32, device=device)
    return col[:, None].expand(len(fc), n_cols)


def run(scale, seed: int = 17, device=None) -> list[dict]:
    device = resolve_device(device)
    params = PhysicsParams()
    n = min(scale.n_cols, 16384)
    sense = torch.tensor(params.sigma_static, dtype=torch.float32,
                         device=device) * torch.randn(
        n, generator=generator(seed, "manufacture", device=device),
        device=device, dtype=torch.float32)
    rows = []
    for x, cfg in CONFIGS.items():
        fc, (c_sum, c_sw) = cfg["fc"], cfg["const"]
        ladder = make_ladder(fc, params)
        with timed(f"majx X={x}"):
            base_ecr, _ = measure_ecr_majx(
                generator(seed, "baseline", x, device=device), sense,
                _neutral_charges(fc, n, params, device), params, sum(fc), x,
                c_sum, c_sw, n_trials=scale.n_trials_maj5)
            levels = identify_calibration(
                generator(seed, "calibrate", x, device=device), sense,
                ladder, params,
                CalibrationConfig(maj_inputs=x, const_charge_sum=c_sum,
                                  const_swing_sq=c_sw))
            tune_ecr, _ = measure_ecr_majx(
                generator(seed, "tuned", x, device=device), sense,
                levels_to_charges(ladder, levels, params), params,
                ladder.n_fracs, x, c_sum, c_sw, n_trials=scale.n_trials_maj5)
        rows.append({
            "majx": f"MAJ{x}",
            "calib_rows": len(fc),
            "ladder_levels": ladder.n_levels,
            "ecr_uncalibrated_pct": 100 * base_ecr,
            "ecr_pudtune_pct": 100 * tune_ecr,
            "error_free_gain": (1 - tune_ecr) / max(1e-9, 1 - base_ecr),
        })
    return rows


def report(scale, device=None) -> None:
    rows = run(scale, device=device)
    emit("majx_general", rows,
         header="PUDTune generalized across MAJX input sizes")
    print("MAJX generalization (free rows -> ladder -> recoverable columns):")
    for r in rows:
        print(f"  {r['majx']}: {r['calib_rows']} calib row(s), "
              f"{r['ladder_levels']}-level ladder: ECR "
              f"{r['ecr_uncalibrated_pct']:.1f}% -> "
              f"{r['ecr_pudtune_pct']:.1f}%  "
              f"({r['error_free_gain']:.2f}x error-free columns)")
    m7 = next(r for r in rows if r["majx"] == "MAJ7")
    m5 = next(r for r in rows if r["majx"] == "MAJ5")
    print(f"  -> MAJ7's single free row caps the gain at "
          f"{m7['error_free_gain']:.2f}x vs MAJ5's "
          f"{m5['error_free_gain']:.2f}x — why the paper's full-adder "
          "mapping leans on MAJ5/MAJ3.")


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
