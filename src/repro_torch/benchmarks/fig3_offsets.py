"""Paper Fig. 3: offset-ladder structure for T_{0,0,0} / T_{2,2,2} / T_{2,1,0}
(port of ``benchmarks/fig3_offsets.py``).

Reports, per Frac configuration: number of distinct offset levels, full span
(wide-range axis) and minimum step (fine-grain axis), in cell-charge units
and in V_DD, the quantities Fig. 3 plots qualitatively.  Host arithmetic
only; deterministic.

    python -m repro_torch.benchmarks.fig3_offsets
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.offsets import make_ladder
from repro_torch.pud.physics import PhysicsParams

from .common import emit, parse_scale

CONFIGS = ((0, 0, 0), (2, 2, 2), (2, 1, 0), (1, 1, 1), (3, 2, 1), (2, 1, 1))


def run(params: PhysicsParams = PhysicsParams()) -> list[dict]:
    rows = []
    for fc in CONFIGS:
        lad = make_ladder(fc, params)
        offs = np.asarray(lad.offsets_units)
        rows.append({
            "config": "T" + "".join(map(str, fc)),
            "n_levels": lad.n_levels,
            "span_units": float(offs[-1] - offs[0]),
            "min_step_units": float(np.diff(offs).min()),
            "span_vdd": float((offs[-1] - offs[0]) * params.cell_weight),
            "min_step_vdd": float(np.diff(offs).min() * params.cell_weight),
            "offsets_units": " ".join(f"{o:+.3f}" for o in offs),
        })
    return rows


def report(scale=None, device=None) -> None:
    """Emit the rows and check the structure Fig. 3 shows (raises
    ``AssertionError`` as the reference does)."""
    rows = run()
    emit("fig3_offsets", rows,
         header="offset ladders; span=range axis, min_step=granularity axis")
    by = {r["config"]: r for r in rows}
    t000, t222, t210 = by["T000"], by["T222"], by["T210"]
    print("Fig. 3 structure checks:")
    print(f"  T000: {t000['n_levels']} levels, span {t000['span_units']:.2f}"
          f" (wide), step {t000['min_step_units']:.2f} (coarse)")
    print(f"  T222: {t222['n_levels']} levels, span {t222['span_units']:.2f}"
          f" (narrow), step {t222['min_step_units']:.2f} (fine)")
    print(f"  T210: {t210['n_levels']} levels, span {t210['span_units']:.2f}"
          f" (wide), step {t210['min_step_units']:.2f} (fine)  <- both")
    assert t210["n_levels"] == 8
    assert t210["span_units"] > 2.5 * t222["span_units"]
    assert t210["min_step_units"] <= t222["min_step_units"] + 1e-9


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
