"""Paper Table I: ECR and throughput, baseline B_{3,0,0} vs PUDTune T_{2,1,0}
(port of ``benchmarks/table1.py``).

Full pipeline per method: manufacture a subarray (sense offsets ~ fitted
N(0, sigma_static)) -> identify calibration data (Algorithm 1, PUDTune only)
-> Monte-Carlo MAJ5 ECR (paper protocol: random inputs, error-free = zero
errors) -> compound ADD8/MUL8 graph ECR -> DDR4-2133 Eq.-1 throughput.

Paper targets:  ECR 46.6% -> 3.3%; MAJ5 0.89 -> 1.62 TOPS (1.81x);
ADD8 50.2 -> 94.6 GOPS (1.88x); MUL8 5.8 -> 11.0 GOPS (1.89x).

    python -m repro_torch.benchmarks.table1 [--full] [--n-cols N]
        [--device cpu]
"""
from __future__ import annotations

from repro_torch.core.calibrate import CalibrationConfig
from repro_torch.core.throughput import evaluate_method

from .common import emit, parse_scale, ratio_line, timed

PAPER = {
    "B300": dict(ecr=0.466, maj5=0.89e12, add=50.2e9, mul=5.8e9),
    "T210": dict(ecr=0.033, maj5=1.62e12, add=94.6e9, mul=11.0e9),
}


def run(scale, seed: int = 2025, device=None,
        calib_config: CalibrationConfig = CalibrationConfig()
        ) -> list[dict]:
    """The two methods on one manufactured subarray (the same ``seed``),
    then their gains; each method's stage walls are printed."""
    rows = []
    results = {}
    for name in ("B300", "T210"):
        with timed(f"table1 {name}"):
            r = evaluate_method(
                seed, name, n_cols=scale.n_cols,
                n_trials_maj5=scale.n_trials_maj5,
                n_cols_arith=scale.n_cols_arith,
                n_trials_arith=scale.n_trials_arith,
                calib_config=calib_config, device=device)
        print("    stages: " + ", ".join(f"{k} {v:.3f}s"
                                         for k, v in r.stage_s.items()))
        results[name] = r
        rows.append({
            "method": name,
            "ecr_pct": 100 * r.ecr,
            "ecr_add_pct": 100 * r.ecr_add,
            "ecr_mul_pct": 100 * r.ecr_mul,
            "maj5_tops": r.maj5_tops / 1e12,
            "add8_gops": r.add8_gops / 1e9,
            "mul8_gops": r.mul8_gops / 1e9,
            "maj5_latency_us": r.maj5_latency_us,
            "paper_ecr_pct": 100 * PAPER[name]["ecr"],
            "paper_maj5_tops": PAPER[name]["maj5"] / 1e12,
            "paper_add8_gops": PAPER[name]["add"] / 1e9,
            "paper_mul8_gops": PAPER[name]["mul"] / 1e9,
        })
    b, t = results["B300"], results["T210"]
    rows.append({
        "method": "gain_T210_over_B300",
        "ecr_pct": float("nan"),
        "ecr_add_pct": float("nan"),
        "ecr_mul_pct": float("nan"),
        "maj5_tops": t.maj5_tops / b.maj5_tops,
        "add8_gops": t.add8_gops / b.add8_gops,
        "mul8_gops": t.mul8_gops / b.mul8_gops,
        "maj5_latency_us": t.maj5_latency_us / b.maj5_latency_us,
        "paper_ecr_pct": float("nan"),
        "paper_maj5_tops": 1.81,
        "paper_add8_gops": 1.88,
        "paper_mul8_gops": 1.89,
    })
    return rows


def report(scale, device=None) -> None:
    """Run both methods, emit the rows and print the validation lines."""
    rows = run(scale, device=device)
    emit("table1", rows,
         header="paper Table I; gains row compares T210/B300")
    b, t, g = rows
    print("Table I validation vs paper:")
    print(ratio_line("ECR(B300) %", b["ecr_pct"], 46.6))
    print(ratio_line("ECR(T210) %", t["ecr_pct"], 3.3, tol=0.5))
    print(ratio_line("MAJ5(B300) TOPS", b["maj5_tops"], 0.89))
    print(ratio_line("MAJ5(T210) TOPS", t["maj5_tops"], 1.62))
    print(ratio_line("ADD8(B300) GOPS", b["add8_gops"], 50.2))
    print(ratio_line("ADD8(T210) GOPS", t["add8_gops"], 94.6))
    print(ratio_line("MUL8(B300) GOPS", b["mul8_gops"], 5.8))
    print(ratio_line("MUL8(T210) GOPS", t["mul8_gops"], 11.0))
    print(ratio_line("MAJ5 gain", g["maj5_tops"], 1.81))
    print(ratio_line("ADD8 gain", g["add8_gops"], 1.88))
    print(ratio_line("MUL8 gain", g["mul8_gops"], 1.89))


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
