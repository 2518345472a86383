"""Fleet calibration benchmark: whole-grid Algorithm 1 (port of
``benchmarks/fleet_calibration.py``).

    python -m repro_torch.benchmarks.fleet_calibration [--full]
        [--method fused|reference] [--check-full] [--device cpu]

Tracks, per run:
  * wall-clock of the fleet calibration (16+ subarrays; ``fused`` launches
    the ``calib_iter`` kernel once per iteration on the card) and of the
    persisted-table reload that serving uses instead of recalibrating;
  * the aggregate error-free-column trajectory: fleet-mean ECR for the
    uncalibrated baseline B_{3,0,0} vs the calibrated T_{2,1,0} grid, with
    the per-subarray distribution (min/max/p90);
  * a parity leg: the fused kernel against its plain version, bit for bit
    (at a small size; ``--check-full`` holds the main leg itself against
    the other method on the same inputs too);
  * agreement with the single-subarray path (the same per-subarray stream
    protocol), the fleet engine's correctness anchor;
  * ADD8/MUL8 fleet-aggregate throughput (Table I's headline ratios, as
    distributions over subarrays).
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core.calibrate import CalibrationConfig, identify_calibration
from repro_torch.core.ecr import (fleet_ecr_summary, measure_ecr_fleet,
                                  measure_ecr_maj5)
from repro_torch.core.fleet import (FleetConfig, calibrate_fleet,
                                    fleet_calib_charges, manufacture_fleet)
from repro_torch.core.offsets import baseline_charges
from repro_torch.core.rng import derive_seed, generator
from repro_torch.core.throughput import fleet_throughput
from repro_torch.devices import resolve_device
from repro_torch.pud.physics import PhysicsParams
from repro_torch.runtime.session import PUDSession

from .common import add_device_arg, emit, ratio_line

PAPER_ADD_GAIN = 1.81   # Table I: ADD8 throughput gain T210 vs B300
PAPER_MUL_GAIN = 1.88   # Table I: MUL8 throughput gain
SEED = 2026


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"fleet_calibration: {msg}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale columns per subarray (65536)")
    ap.add_argument("--subarrays", type=int, default=16)
    ap.add_argument("--n-cols", type=int, default=None)
    ap.add_argument("--n-trials", type=int, default=2048)
    ap.add_argument("--method", default="fused",
                    choices=("reference", "fused"),
                    help="calibration engine of the main leg: 'fused' "
                         "launches the calib_iter kernel on the card (its "
                         "plain version on the CPU); 'reference' runs the "
                         "plain version; a short parity leg always runs")
    ap.add_argument("--check-full", action="store_true",
                    help="run the main leg again with the other method on "
                         "the same inputs and require equal levels and "
                         "bias (the kernel against its plain version at "
                         "the main leg's size)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n_cols = args.n_cols or (65536 if args.full else 4096)
    cfg = FleetConfig(n_channels=1, n_banks=4,
                      n_subarrays=max(1, args.subarrays // 4),
                      n_cols=n_cols)
    params = PhysicsParams()
    ladder = cfg.ladder(params)
    cal_cfg = CalibrationConfig()

    print(f"[fleet] grid {cfg.grid_shape} x {cfg.n_cols} cols "
          f"({cfg.n_subarrays_total} subarrays, "
          f"{cfg.n_cols_total:,} columns total) on {device}")

    offsets = manufacture_fleet(SEED, cfg, params, device)

    # --- whole-grid Algorithm 1 -------------------------------------------
    sync()
    t0 = time.time()
    cal = calibrate_fleet(SEED, offsets, cfg, params, cal_cfg,
                          method=args.method)
    sync()
    t_fleet = time.time() - t0
    hist = cal.mean_abs_bias.cpu().numpy()
    print(f"  fleet calibration ({args.method}, {cal_cfg.n_iterations} "
          f"iters): {t_fleet:.3f}s wall")
    print(f"  bias trajectory: {hist[0]:.4f} -> {hist[-1]:.4f}")
    if args.check_full:
        other = "reference" if args.method == "fused" else "fused"
        sync()
        t0 = time.time()
        check = calibrate_fleet(SEED, offsets, cfg, params, cal_cfg,
                                method=other)
        sync()
        t_other = time.time() - t0
        _check(torch.equal(cal.levels, check.levels)
               and torch.equal(cal.mean_abs_bias, check.mean_abs_bias),
               f"the main leg ({args.method}) differs from {other} on the "
               "same inputs")
        print(f"  main leg == {other} on the same inputs, bit for bit: "
              f"calib_iter at [{cfg.n_subarrays_total}, "
              f"{cal_cfg.n_samples}, {cal_cfg.maj_inputs}, {cfg.n_cols}] x "
              f"{cal_cfg.n_iterations} iters; {other} {t_other:.3f}s wall")
        del check

    # --- parity leg: the fused kernel against its plain version ----------
    small = FleetConfig(n_channels=1, n_banks=4, n_subarrays=4, n_cols=512)
    small_cal = CalibrationConfig(n_iterations=4, n_samples=256)
    offs_small = manufacture_fleet(SEED, small, params, device)
    t0 = time.time()
    fused = calibrate_fleet(SEED, offs_small, small, params, small_cal,
                            method="fused")
    sync()
    t_fused = time.time() - t0
    t0 = time.time()
    ref = calibrate_fleet(SEED, offs_small, small, params, small_cal,
                          method="reference")
    sync()
    t_ref = time.time() - t0
    _check(torch.equal(fused.levels, ref.levels)
           and torch.equal(fused.mean_abs_bias, ref.mean_abs_bias),
           "the fused kernel differs from its plain version")
    print(f"  fused kernel parity (16x512, 4 iters): bit-exact; "
          f"{t_fused:.3f}s fused vs {t_ref:.3f}s plain version")

    # --- aggregate ECR: calibrated vs baseline ----------------------------
    charges = fleet_calib_charges(ladder, cal.levels, params)
    s_ecr = derive_seed(SEED, 0xECC)
    ecr_tune, masks = measure_ecr_fleet(
        s_ecr, offsets, charges, params, ladder.n_fracs,
        n_trials=args.n_trials, chunk=256)
    base = baseline_charges(3, cfg.n_cols, params, device=device)[None] \
        .expand(cfg.n_subarrays_total, 3, cfg.n_cols)
    ecr_base, _ = measure_ecr_fleet(
        s_ecr, offsets, base, params, 3, n_trials=args.n_trials, chunk=256)
    s = fleet_ecr_summary(masks)
    print(f"  fleet ECR: B300 {float(ecr_base.mean()):.3f} -> "
          f"T210 {s['mean_ecr']:.3f} "
          f"(min {s['min_ecr']:.3f} / p90 {s['p90_ecr']:.3f} / "
          f"max {s['max_ecr']:.3f}); "
          f"error-free columns {s['error_free_cols_total']:,}"
          f"/{s['cols_total']:,}")

    # --- single-subarray agreement (the correctness anchor) ---------------
    g = 0
    sync()
    t0 = time.time()
    lv_single = identify_calibration(
        generator(SEED, "calibrate", g, device=device), offsets[g], ladder,
        params, cal_cfg)
    sync()
    t_single = time.time() - t0
    ecr_single, _ = measure_ecr_maj5(
        generator(s_ecr, "ecr", g, device=device), offsets[g],
        fleet_calib_charges(ladder, lv_single[None], params)[0],
        params, ladder.n_fracs, n_trials=args.n_trials, chunk=256)
    gain_fleet = (1 - s["mean_ecr"]) / (1 - float(ecr_base.mean()))
    gain_single = (1 - ecr_single) / (1 - float(ecr_base[g]))
    print(f"  single-subarray path: {t_single:.3f}s/subarray "
          f"(fleet amortized {t_fleet / cfg.n_subarrays_total:.3f}s); "
          f"error-free gain fleet {gain_fleet:.3f} vs single "
          f"{gain_single:.3f}")
    _check(abs(gain_fleet - gain_single) < 0.05 * gain_single,
           f"fleet gain {gain_fleet} vs single-subarray {gain_single}")

    # --- cached-table startup (what a PUDSession does) --------------------
    levels_np = cal.levels.cpu().numpy()
    with tempfile.TemporaryDirectory() as d:
        session = PUDSession.open(grid=cfg, cache_dir=d, device_id="bench0",
                                  calib=cal_cfg, seed=SEED, device=device)
        session.cache.save("bench0", cfg, params, levels_np,
                           ecr=ecr_tune.cpu().numpy(),
                           masks=masks.cpu().numpy())
        state = session.calibrate()
        t_hit = state.wall_s
        _check(state.cache_hit, "the saved table missed")
        _check(bool((state.levels.cpu().numpy() == levels_np).all()),
               "the cached levels differ from the calibrated ones")
        print(f"  cached-table startup: HIT in {t_hit:.3f}s "
              f"(vs {t_fleet:.3f}s recalibration) — serve starts "
              f"{t_fleet / max(t_hit, 1e-3):.0f}x faster")

    # --- fleet-aggregate arithmetic throughput ----------------------------
    ecr_t, ecr_b = ecr_tune.cpu().numpy(), ecr_base.cpu().numpy()
    add_t = fleet_throughput("T210", "add8", ecr_t, 3)
    add_b = fleet_throughput("B300", "add8", ecr_b, 3)
    mul_t = fleet_throughput("T210", "mul8", ecr_t, 3)
    mul_b = fleet_throughput("B300", "mul8", ecr_b, 3)
    print(ratio_line("ADD8 fleet gain", add_t.speedup_vs(add_b),
                     PAPER_ADD_GAIN))
    print(ratio_line("MUL8 fleet gain", mul_t.speedup_vs(mul_b),
                     PAPER_MUL_GAIN))
    print(f"  ADD8 p10-p90 across subarrays: "
          f"{add_t.percentile(10) / 1e9:.1f}-"
          f"{add_t.percentile(90) / 1e9:.1f} GOPS")

    emit("fleet_calibration", [{
        "subarrays": cfg.n_subarrays_total, "n_cols": cfg.n_cols,
        "method": args.method,
        "wall_s": t_fleet, "wall_single_s": t_single,
        "wall_fused_small_s": t_fused, "wall_ref_small_s": t_ref,
        "cache_hit_s": t_hit,
        "ecr_base": float(ecr_base.mean()), "ecr_tune": s["mean_ecr"],
        "ecr_min": s["min_ecr"], "ecr_max": s["max_ecr"],
        "gain_fleet": gain_fleet, "gain_single": gain_single,
        "add8_gain": add_t.speedup_vs(add_b),
        "mul8_gain": mul_t.speedup_vs(mul_b),
        "bias_first": float(hist[0]), "bias_last": float(hist[-1]),
    }], header="fleet calibration wall-clock + aggregate-ECR trajectory")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
