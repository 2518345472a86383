"""End-to-end method evaluation: ECR + Eq.-1 throughput, paper Table I
(port of ``repro/core/throughput.py``).

``evaluate_method`` runs the whole pipeline for one MAJ5 implementation
(baseline B_{x,0,0} or PUDTune T_{x,y,z}):

    manufacture subarray -> [identify calibration data (Algorithm 1)] ->
    measure MAJ5 ECR (Monte-Carlo, paper protocol) ->
    measure ADD8/MUL8 compound ECR on the MAJ graphs ->
    price command sequences on the DDR4-2133 model -> Eq. 1 throughput.

MAJ5 TOPS uses the standalone MAJ5 sequence; ADD/MUL use the staged
arithmetic sequences (see pud/bitserial.py).  It runs on ``cuda`` unless
``device="cpu"`` is passed; without a GPU it raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.pud.bitserial import (MajContext, add8_counts,
                                       maj5_standalone_counts, mul8_counts)
from repro_torch.pud.physics import PhysicsParams
from repro_torch.pud.timing import (SystemConfig, throughput_ops,
                                    wave_latency_ns)

from .calibrate import CalibrationConfig, identify_calibration
from .ecr import measure_ecr_graph, measure_ecr_maj5
from .offsets import baseline_charges, levels_to_charges, make_ladder
from .rng import generator


@dataclasses.dataclass
class MethodResult:
    name: str
    ecr: float                    # MAJ5 error-prone column ratio
    ecr_add: float
    ecr_mul: float
    maj5_tops: float
    add8_gops: float
    mul8_gops: float
    maj5_latency_us: float
    levels: torch.Tensor | None = None
    error_free_mask: torch.Tensor | None = None   # per measured column
    #: host wall seconds of each stage ("calibrate", "ecr_maj5",
    #: "ecr_graph"), each ended by a device synchronize
    stage_s: dict | None = None

    def row(self) -> str:
        return (f"{self.name},{self.ecr:.4f},{self.maj5_tops / 1e12:.3f},"
                f"{self.add8_gops / 1e9:.1f},{self.mul8_gops / 1e9:.2f}")


def _parse_method(name: str) -> tuple[str, tuple[int, int, int]]:
    """'B300' -> ('baseline', (3,0,0)); 'T210' -> ('pudtune', (2,1,0))."""
    kind = "baseline" if name[0] == "B" else "pudtune"
    fc = tuple(int(c) for c in name[1:4])
    return kind, fc


def evaluate_method(
    seed: int,
    name: str,
    params: PhysicsParams = PhysicsParams(),
    sys: SystemConfig = SystemConfig(),
    n_cols: int = 65536,
    n_trials_maj5: int = 8192,
    n_cols_arith: int = 4096,
    n_trials_arith: int = 512,
    calib_config: CalibrationConfig = CalibrationConfig(),
    with_arith: bool = True,
    device=None,
) -> MethodResult:
    """One Table-I row.  The same ``seed`` manufactures the same subarray
    for every method, as the reference's shared key does."""
    device = resolve_device(device)
    kind, fc = _parse_method(name)
    stages: dict[str, float] = {}

    def mark(stage: str, t0: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        stages[stage] = t1 - t0
        return t1

    draw = torch.randn(n_cols, generator=generator(seed, "manufacture",
                                                   device=device),
                       device=device, dtype=torch.float32)
    sense_offset = torch.tensor(params.sigma_static, dtype=torch.float32,
                                device=device) * draw

    t0 = time.perf_counter()
    levels = None
    if kind == "baseline":
        calib_charge = baseline_charges(fc[0], n_cols, params, device=device)
        n_fracs = fc[0]
    else:
        ladder = make_ladder(fc, params)
        levels = identify_calibration(
            generator(seed, "calibrate", device=device), sense_offset,
            ladder, params, calib_config)
        calib_charge = levels_to_charges(ladder, levels, params)
        n_fracs = ladder.n_fracs
    t0 = mark("calibrate", t0)

    ecr5, err_mask = measure_ecr_maj5(
        generator(seed, "ecr", device=device), sense_offset, calib_charge,
        params, n_fracs, n_trials=n_trials_maj5)
    t0 = mark("ecr_maj5", t0)
    ef5 = (1.0 - ecr5) * sys.n_cols_per_subarray
    maj5_cnt = maj5_standalone_counts(n_fracs)
    maj5_tput = throughput_ops(maj5_cnt, ef5, sys)

    ecr_add = ecr_mul = float("nan")
    add_tput = mul_tput = float("nan")
    if with_arith:
        # Compound-graph ECR on a column subsample (the graphs are ~100x the
        # MAJ count of a single MAJ5; same protocol, fewer columns/trials).
        ctx = MajContext(params=params,
                         sense_offset=sense_offset[:n_cols_arith],
                         calib_charge=calib_charge[:, :n_cols_arith],
                         n_fracs=n_fracs)
        ecr_add, _ = measure_ecr_graph(
            generator(seed, "add8", device=device), ctx, "add8",
            n_trials=n_trials_arith)
        ecr_mul, _ = measure_ecr_graph(
            generator(seed, "mul8", device=device), ctx, "mul8",
            n_trials=max(64, n_trials_arith // 4))
        add_tput = throughput_ops(
            add8_counts(n_fracs),
            (1.0 - ecr_add) * sys.n_cols_per_subarray, sys)
        mul_tput = throughput_ops(
            mul8_counts(n_fracs),
            (1.0 - ecr_mul) * sys.n_cols_per_subarray, sys)
        mark("ecr_graph", t0)

    return MethodResult(
        name=name, ecr=ecr5, ecr_add=ecr_add, ecr_mul=ecr_mul,
        maj5_tops=maj5_tput, add8_gops=add_tput, mul8_gops=mul_tput,
        maj5_latency_us=wave_latency_ns(maj5_cnt, sys) / 1e3,
        levels=levels, error_free_mask=~err_mask, stage_s=stages)


# ---------------------------------------------------------------------------
# Fleet-aggregate throughput: Table I's numbers as distributions over
# subarrays instead of one point estimate.
# ---------------------------------------------------------------------------

_OP_COUNTS = {"maj5": maj5_standalone_counts, "add8": add8_counts,
              "mul8": mul8_counts}


@dataclasses.dataclass
class FleetThroughput:
    """Per-subarray and device-aggregate ops/s for one PUD op graph."""

    name: str
    op: str                            # "maj5" | "add8" | "mul8"
    per_subarray: np.ndarray           # ops/s at each subarray's ECR
    aggregate: float                   # ops/s at the fleet-mean ECR
    mean_ecr: float

    def percentile(self, q: float) -> float:
        return float(np.percentile(self.per_subarray, q))

    def speedup_vs(self, baseline: "FleetThroughput") -> float:
        return self.aggregate / baseline.aggregate

    def row(self) -> str:
        return (f"{self.name},{self.op},{self.mean_ecr:.4f},"
                f"{self.aggregate:.4g},{self.percentile(10):.4g},"
                f"{self.percentile(90):.4g}")


def fleet_throughput(name: str, op: str, ecr_per_subarray, n_fracs: int,
                     sys: SystemConfig = SystemConfig()) -> FleetThroughput:
    """Eq. 1 evaluated per subarray and at the fleet mean.

    ``per_subarray[g]`` is the rate the full system would sustain were every
    bank wave served at subarray g's error-free fraction; ``aggregate``
    prices waves rotating uniformly over the grid (mean error-free
    fraction).
    """
    counts = _OP_COUNTS[op](n_fracs)
    if isinstance(ecr_per_subarray, torch.Tensor):
        ecr_per_subarray = ecr_per_subarray.cpu()
    ecr = np.asarray(ecr_per_subarray, np.float64)
    per = np.array([
        throughput_ops(counts, (1.0 - e) * sys.n_cols_per_subarray, sys)
        for e in ecr])
    agg = throughput_ops(
        counts, float((1.0 - ecr).mean()) * sys.n_cols_per_subarray, sys)
    return FleetThroughput(name=name, op=op, per_subarray=per,
                           aggregate=agg, mean_ecr=float(ecr.mean()))
