"""Column-placement benchmark: what faulty-column avoidance costs and buys
(port of ``benchmarks/placement.py``).

Opens a ``PUDSession`` on a small fleet, calibrates it in memory, packs a
smoke model's packable projections (FFN and attention) onto the error-free
columns, and reports:

  * capacity / occupancy of the placement (used vs usable error-free
    columns),
  * the serving rate priced two ways: the mean-ECR fleet model and the
    placement-derived occupancy model,
  * the correctness stake: the share of an unplaced (identity) layout's
    columns that would sit on faulty silicon, i.e. what placement avoids.

Runs in seconds at its own smoke configuration (``--full`` changes
nothing).  With ``BenchScale.check_plain`` the run is repeated on the plain
PyTorch versions and must give the same table, placement and row.

    python -m repro_torch.benchmarks.placement [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs import get
from repro_torch.core.calibrate import CalibrationConfig
from repro_torch.core.fleet import FleetConfig
from repro_torch.models.params import init_params
from repro_torch.pud.gemv import ATTN_PACKABLE, FFN_PACKABLE, PUDGemvConfig
from repro_torch.pud.packer import packing_requests
from repro_torch.pud.placement import plan_for_grid
from repro_torch.runtime.session import PUDSession

from .common import emit, hold_to_plain, parse_scale, plain_backend

ARCH = "qwen3-1.7b"


def run(scale=None, device=None) -> list[dict]:
    return _run(device, plain=False)[0]


def _run(device, plain: bool) -> tuple[list[dict], dict]:
    """The benchmark on the kernels or (``plain``) the plain PyTorch
    versions: its rows, and what the kernels computed (the table's levels
    and masks, each placed tensor's physical columns)."""
    cfg = FleetConfig(n_channels=1, n_banks=2, n_subarrays=4, n_cols=512)
    session = PUDSession.open(
        ARCH, grid=cfg, seed=11,
        calib=CalibrationConfig(n_iterations=8, n_samples=128),
        n_trials_ecr=512, device=device, **plain_backend(plain))
    state = session.calibrate()          # in memory: no cache_dir given

    model = get(ARCH).make_smoke()
    weights = init_params(model.param_defs(), 0, session.device)
    gcfg = PUDGemvConfig(packable=FFN_PACKABLE + ATTN_PACKABLE)
    session.pack(weights, gcfg, name=f"{ARCH}-smoke")
    assert session.placement_status == "planned", session.placement_error

    # the identity layout computes on every column it touches, faulty ones
    # included: only its error-free share gives usable results
    reqs = packing_requests(weights, gcfg)
    masks = state.masks.cpu().numpy()
    identity = plan_for_grid(masks, reqs, cfg.grid_shape, avoid_faulty=False)
    ident_cols = np.concatenate(
        [np.asarray(tp.phys_cols).reshape(-1)
         for tp in identity.entries.values()])
    faulty_frac = float(masks.reshape(-1)[ident_cols].mean())

    perf = session.perf_report()
    rep = perf["placement"]
    computed = {"levels": state.levels, "masks": state.masks,
                "phys_cols": {k: np.asarray(tp.phys_cols).tolist()
                              for k, tp in session.placement.entries.items()}}
    return [{
        "arch": ARCH,
        "subarrays": cfg.n_subarrays_total,
        "cols_per_subarray": cfg.n_cols,
        "mean_ecr": state.mean_ecr,
        "demand_cols": sum(r.total_cols for r in reqs),
        "usable_cols": rep["usable_cols"],
        "occupancy": rep["occupancy"],
        "spilled_tensors": len(rep["spilled_tensors"]),
        "unplaced_faulty_frac": faulty_frac,
        "tok_s_mean_ecr": perf["tuned_tok_s"],
        "tok_s_placed": perf["placed_tok_s"],
        "calib_s": state.wall_s,
    }], computed


def report(scale=None, device=None) -> None:
    rows, computed = _run(device, plain=False)
    if scale is not None and scale.check_plain:
        plain_rows, plain_computed = _run(device, plain=True)
        # the calibration's host wall is the one field that may differ
        strip = [[{k: v for k, v in r.items() if k != "calib_s"}
                  for r in rs] for rs in (rows, plain_rows)]
        hold_to_plain("placement", (strip[0], computed),
                      (strip[1], plain_computed))
    emit("placement", rows,
         header="column placement occupancy + serving rate (smoke fleet)")
    r = rows[0]
    print(f"placement ({r['subarrays']} subarrays x "
          f"{r['cols_per_subarray']} cols, mean ECR {r['mean_ecr']:.3f}, "
          f"calibrated in {r['calib_s']:.1f}s):")
    print(f"  demand {r['demand_cols']:,} cols -> occupancy "
          f"{r['occupancy']:.1%} of {r['usable_cols']:,} error-free cols "
          f"({r['spilled_tensors']} tensors spill subarrays)")
    print(f"  without placement, {r['unplaced_faulty_frac']:.1%} of used "
          f"columns would sit on faulty silicon (silent corruption)")
    print(f"  tokens/s ({ARCH} full config): mean-ECR model "
          f"{r['tok_s_mean_ecr']:.2f} vs placement-derived "
          f"{r['tok_s_placed']:.2f}")


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
