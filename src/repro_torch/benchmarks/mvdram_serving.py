"""The MVDRAM serving table: end-to-end PUD decode rates for every arch the
port registers, baseline vs PUDTune calibration (port of
``benchmarks/mvdram_serving.py``; Eq. 1 applied to the bit-serial MAC
schedule of ``pud/bitserial.py`` priced on DDR4-2133).

Tokens per second a 4-channel DDR4 PUD system sustains for decode, and how
much of that rate PUDTune's extra error-free columns buy.  Single-request
rates come from sessions pinned at the Table-I operating points
(``PUDSession.at_operating_point``).  The batched columns price
continuous-batching decode with ``FleetPerfModel``'s batch extension at
batch 2 and at the residency-derived optimum; the sharded columns an even
tensor-parallel split over 1, 2 and 4 identical pinned devices
(``FleetPerfAggregate``).  Host arithmetic only: no kernel runs.

    python -m repro_torch.benchmarks.mvdram_serving [--device cpu]
"""
from __future__ import annotations

from repro_torch.configs import all_archs, get
from repro_torch.pud.gemv import (ECR_BASELINE_B300, ECR_PUDTUNE_T210,
                                  FleetPerfAggregate, FleetPerfModel)
from repro_torch.runtime.session import PUDSession

from .common import emit, parse_scale

SHARD_COUNTS = (1, 2, 4)


def run(scale=None, device=None) -> list[dict]:
    base = PUDSession.at_operating_point(ECR_BASELINE_B300, device=device)
    tune = PUDSession.at_operating_point(ECR_PUDTUNE_T210, device=device)
    tune_fleet = FleetPerfModel.from_table([ECR_PUDTUNE_T210])
    opt = tune_fleet.optimal_batch_size()
    shard_aggs = {s: FleetPerfAggregate(shards=(tune_fleet,) * s, n_data=1)
                  for s in SHARD_COUNTS}
    rows = []
    for arch in all_archs():
        spec = get(arch)
        flops_tok = 2 * spec.n_active_params
        rows.append({
            "arch": arch,
            "active_params_B": spec.n_active_params / 1e9,
            "baseline_tok_s": base.tokens_per_second(flops_tok),
            "pudtune_tok_s": tune.tokens_per_second(flops_tok),
            "gain": tune.tuned_perf_model().speedup_vs(
                base.tuned_perf_model()),
            "batch2_tok_s": tune_fleet.batched_tokens_per_second(
                flops_tok, 2),
            "batch_opt": opt,
            "batch_opt_tok_s": tune_fleet.batched_tokens_per_second(
                flops_tok, opt),
            **{f"shard{s}_tok_s": shard_aggs[s].tokens_per_second(flops_tok)
               for s in SHARD_COUNTS},
            "shard4_eff": shard_aggs[4].scaling_efficiency(flops_tok),
        })
    return rows


def report(scale=None, device=None) -> list[dict]:
    rows = run(scale, device)
    emit("mvdram_serving", rows,
         header="decode on 4-channel DDR4 PUD, 8-bit weights; batched = "
                "continuous-batching aggregate rate")
    print("MVDRAM serving model (Eq. 1, per calibrated device):")
    for r in rows:
        print(f"  {r['arch']:<26s} {r['active_params_B']:6.2f}B active: "
              f"{r['baseline_tok_s']:7.3f} -> {r['pudtune_tok_s']:7.3f} tok/s"
              f"  ({r['gain']:.2f}x)"
              f"  | batched: {r['batch2_tok_s']:7.3f} @2, "
              f"{r['batch_opt_tok_s']:7.3f} @{r['batch_opt']} (opt)"
              f"  | sharded: {r['shard2_tok_s']:7.3f} @2, "
              f"{r['shard4_tok_s']:7.3f} @4 ({r['shard4_eff']:.0%} eff)")
    return rows


def main(argv=None) -> int:
    scale, device = parse_scale(argv, description=__doc__)
    report(scale, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
