"""Paper Fig. 5: MAJ5 ECR / throughput sensitivity to the Frac configuration
(port of ``benchmarks/fig5_frac_sensitivity.py``).

Sweeps baselines B_{x,0,0} and PUDTune T_{x,y,z} over Frac counts on one
manufactured subarray (``core/throughput.evaluate_method``, MAJ5 only) and
checks the paper's two quantitative claims: T210 = 1.03x T000 and 1.48x
T222 in MAJ5 throughput, and that PUDTune beats the baseline at every
matched Frac budget.

    python -m repro_torch.benchmarks.fig5_frac_sensitivity [--full]
        [--n-cols N] [--device cpu]
"""
from __future__ import annotations

from repro_torch.core.throughput import evaluate_method

from .common import emit, parse_scale, ratio_line, timed

BASELINES = ("B000", "B100", "B200", "B300", "B400", "B600")
PUDTUNE = ("T000", "T100", "T110", "T111", "T210", "T211", "T221",
           "T222", "T321")


def run(scale, seed: int = 7, device=None) -> list[dict]:
    """One row per method, every method on the subarray ``seed`` makes."""
    rows = []
    for name in BASELINES + PUDTUNE:
        with timed(f"fig5 {name}"):
            r = evaluate_method(
                seed, name, n_cols=scale.n_cols,
                n_trials_maj5=scale.n_trials_maj5, with_arith=False,
                device=device)
        rows.append({
            "method": name,
            "kind": "baseline" if name[0] == "B" else "pudtune",
            "n_fracs": sum(int(c) for c in name[1:4]),
            "ecr_pct": 100 * r.ecr,
            "maj5_tops": r.maj5_tops / 1e12,
            "maj5_latency_us": r.maj5_latency_us,
        })
    return rows


def report(scale, device=None) -> None:
    rows = run(scale, device=device)
    emit("fig5_frac_sensitivity", rows)
    by = {r["method"]: r for r in rows}
    print("Fig. 5 validation vs paper:")
    print(ratio_line("T210/T000 throughput", by["T210"]["maj5_tops"] /
                     by["T000"]["maj5_tops"], 1.03, tol=0.08))
    print(ratio_line("T210/T222 throughput", by["T210"]["maj5_tops"] /
                     by["T222"]["maj5_tops"], 1.48, tol=0.15))
    worst = min(
        by[t]["maj5_tops"] / by[b]["maj5_tops"]
        for t, b in zip(("T000", "T100", "T110", "T210"),
                        ("B000", "B100", "B200", "B300")))
    print(f"  PUDTune vs baseline at matched Frac budgets: worst gain "
          f"{worst:.2f}x (paper: consistently >1)")
    best = max(rows[len(BASELINES):], key=lambda r: r["maj5_tops"])
    print(f"  best configuration: {best['method']} "
          f"({best['maj5_tops']:.2f} TOPS) — paper: T210")
    if best["method"] != "T210":
        print("  NOTE: known model-vs-silicon deviation — the column-global "
              "noise model\n  underestimates coarse-ladder (T100/T110) ECR; "
              "both of the paper's quantified\n  claims (vs T000, vs T222) "
              "reproduce. See repro_torch/core/fit.py.")


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
