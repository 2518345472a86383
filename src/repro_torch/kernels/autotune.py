"""Kernel autotuner: search the launch plans the bit-plane kernels accept
and keep what wins on the card (port of ``repro/kernels/autotune.py``).

Each CUDA GEMM picks its launch plan from a fixed heuristic
(``placed_gemm.plan_launch``, ``plane_gemm.plan_launch``).  The tuner
times the plans the same kernels also accept and keeps the fastest:

  * :class:`TunedPlan`: the free choices of a plan (the path, dp4a or
    tensor cores; rows per block; K words per stage; the K split count;
    ``mode``).  A field left as None keeps the heuristic, so ``TunedPlan()``
    *is* the heuristic plan.  Frozen and hashable: packs carry plans and
    the wrappers' plan caches key on them.
  * :func:`candidate_plans`: the search space, heuristic first: every row
    instance of the path (and, from 17 to 64 rows, dp4a tiles beside the
    half-empty 64-row tensor-core block), every stage size the kernel
    compiles, and the heuristic's split beside a single split (no zeroed
    output, no atomics).  Each is checked by ``analysis/contracts``
    (:func:`valid_candidates`) before it is timed.
  * :func:`tune_kernel`: times every candidate on the card on real
    operands, the heuristic first, and holds every output to the
    heuristic's bit for bit (a plan is an execution choice, never a
    numeric one; a difference raises ``ContractViolation``).  On a CPU
    tensor it raises: there is no kernel to tune there.

A pack stamps one plan per entry and row class (:func:`row_class`: the
GEMV at one row, the dp4a GEMM up to 16 rows, the tensor-core GEMM's
64-row range up to 64 and its 128-row range beyond); the call's B picks
the plan and a class without one runs the heuristic.  The
persistence half is ``runtime/tune.py``; the consumers are
``ops.pud_matmul(tile_plan=)`` and ``PUDSession.tune``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import devices

from . import placed_gemm, plane_gemm
from .backends import get_backend

MODES = ("planes", "folded")

#: Fields of one plan, in serialization order.
PLAN_FIELDS = ("tensor_cores", "rows", "stage_words", "n_split", "mode")

#: Candidates timed per key by default: all of them at the main path's
#: shapes (at most 40), each call about 0.5 ms with its L2 flush
MAX_CANDIDATES = 64

#: bytes zeroed before each timed call, to flush the L2 (the H100's holds
#: 50 MB)
FLUSH_BYTES = 256 * 2**20


@dataclasses.dataclass(frozen=True)
class TunedPlan:
    """One launch plan of a bit-plane kernel call: the choices the
    heuristic would otherwise make.  None keeps the heuristic's."""

    tensor_cores: bool | None = None
    rows: int | None = None
    stage_words: int | None = None
    n_split: int | None = None
    mode: str | None = None

    def is_default(self) -> bool:
        return all(getattr(self, f) is None for f in PLAN_FIELDS)

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in PLAN_FIELDS
                if getattr(self, f) is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "TunedPlan":
        unknown = set(d) - set(PLAN_FIELDS)
        if unknown:
            raise ValueError(f"unknown TunedPlan fields {sorted(unknown)}")
        return cls(**d)


def row_class(b: int) -> str:
    """The plan class of a call with ``b`` rows, one per range of the
    heuristic's row instances: "gemv" (B = 1), "gemm" (2-16, dp4a),
    "gemm_tc64" (17-64, 64-row tensor-core blocks, where dp4a tiles
    compete) and "gemm_tc128" (65 up, 128-row blocks: prefill)."""
    if b == 1:
        return "gemv"
    if b < placed_gemm.TC_MIN_ROWS:
        return "gemm"
    return "gemm_tc64" if b <= placed_gemm.TC_ROWS[0] else "gemm_tc128"


def plan_for_entry(tile_plan, entry: str) -> TunedPlan | None:
    """The plan a pack's ``tile_plan`` stamp holds for one row class
    (``entry``, from :func:`row_class`): a single ``TunedPlan`` serves
    every class, a tuple of ``(class, TunedPlan)`` pairs one each.  None
    when no plan applies, so the heuristic runs."""
    if tile_plan is None:
        return None
    if isinstance(tile_plan, TunedPlan):
        return tile_plan
    for key, plan in tile_plan:
        if key == entry:
            return plan
    return None


def tuning_key(entry: str, b: int, k: int, n: int, wb: int,
               layout: str, placed: bool) -> str:
    """Cache key of one tuning problem, in the reference's format:
    ``entry__kind__layout__BxKxN@WBb``."""
    kind = "placed" if placed else "logical"
    return f"{entry}__{kind}__{layout}__{b}x{k}x{n}@{wb}b"


def median_time(fn, device, *, warmup: int = 1, reps: int = 5):
    """(median seconds, last output) of ``fn()`` on ``device``.

    On a CUDA device: CUDA events around each call, the L2 flushed before
    it and a short spin queued after the flush, so the host's launch time
    does not count (as ``chip_smoke.time_ms``).  On the CPU the host clock,
    which times the plain versions, never a kernel."""
    device = torch.device(device)
    out = None
    for _ in range(max(warmup, 1)):
        out = fn()
    times = []
    if device.type == "cuda":
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
        with torch.cuda.device(device):
            for _ in range(max(reps, 1)):
                flush.zero_()
                torch.cuda._sleep(500_000)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(max(reps, 1)):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


def _launch_plan(b, kw, n, wb, dense, geo, sms, tuned):
    """The plan the wrapper would launch with (``geo``: (window_block,
    block_cols) of a placed call, else None)."""
    if geo is not None:
        return placed_gemm.plan_launch(b, kw, n, wb, *geo, dense, sms, tuned)
    return plane_gemm.plan_launch(b, kw, n, wb, dense, sms, tuned)


def _fits(p, wb: int, dense: bool, placed: bool) -> bool:
    """The two limits a plan's choices can break: shared memory and, for a
    staged placed window, the granules each thread copies per stage."""
    if p.smem_bytes > placed_gemm.SMEM_MAX:
        return False
    if placed and p.row_bytes:
        rpw = 8 if dense else 1
        return (wb * rpw * p.stage_words * (p.row_bytes // 16)
                <= placed_gemm.MAX_COPIES * placed_gemm.THREADS)
    return True


def _paths(entry: str, b: int, heur, placed: bool) -> list[tuple]:
    """(tensor cores, rows) of every path a call of ``b`` rows may take,
    the heuristic's first: the one-row dp4a plan for the GEMV; for the
    GEMM every dp4a row instance of at most 4 row blocks, and from 17 to
    64 rows those beside the tensor-core blocks."""
    if entry == "gemv":
        return [(False, 1)]
    mod = placed_gemm if placed else plane_gemm
    out = [(heur.tensor_cores, heur.rows)]
    if b <= 64:
        out += [(False, r) for r in mod.DP4A_ROWS
                if -(-b // r) <= 4 and (r > 1 or b < mod.TC_MIN_ROWS)]
    if b >= mod.TC_MIN_ROWS:
        tc_rows = [r for r in mod.TC_ROWS if r <= b]
        tc_rows += [r for r in mod.TC_ROWS if r >= b][:1]
        out += [(True, r) for r in tc_rows]
    return list(dict.fromkeys(out))


def _stage_words(tc: bool, dense: bool, placed: bool) -> tuple[int, ...]:
    if placed:
        return tuple(w for w in placed_gemm.STAGE_WORDS
                     if not tc or w % 4 == 0)
    return plane_gemm.STAGE_WORDS if tc else plane_gemm.DP4A_WORDS[dense]


def candidate_plans(entry: str, b: int, k: int, n: int, *,
                    layout: str = "dense", placed_window: int | None = None,
                    pack_window_block: int | None = None, wb: int = 4,
                    mode: str = "folded", sms: int = placed_gemm.SMS
                    ) -> list[TunedPlan]:
    """The search space of one tuning key, heuristic plan first.

    Per path (:func:`_paths`): its heuristic stage size at the heuristic's
    split and at one split, then every other stage size the kernel
    compiles, at its split and at one.  Plans that would launch the same
    as an earlier one, or break shared memory or the copies per thread,
    are dropped.  ``mode`` is not searched: both modes launch the same
    kernel.
    """
    kw = -(-k // 8)
    dense = layout == "dense"
    placed = placed_window is not None
    geo = None
    if placed:
        pwb = pack_window_block or placed_window
        geo = (pwb, n // (placed_window // pwb))

    def plan_of(t):
        return _launch_plan(b, kw, n, wb, dense, geo, sms, t)

    heur = plan_of(None)
    groups: list[list[TunedPlan]] = [[], [], []]
    for tc, rows in _paths(entry, b, heur, placed):
        first = plan_of(TunedPlan(tensor_cores=tc, rows=rows)).stage_words
        words = _stage_words(tc, dense, placed)
        for kc in [first] + [w for w in words if w != first]:
            split = plan_of(TunedPlan(tc, rows, kc)).n_split
            for n_split in dict.fromkeys((split, 1)):
                g = 0 if kc == first else (1 if n_split == split else 2)
                groups[g].append(TunedPlan(tc, rows, kc, n_split))
    out, seen = [TunedPlan()], {heur}
    for plan in (p for g in groups for p in g):
        p = plan_of(plan)
        if p not in seen and p.n_split == plan.n_split and _fits(
                p, wb, dense, placed):
            seen.add(p)
            out.append(plan)
    return out


def valid_candidates(plans, entry: str, x_shape, planes_shape, *,
                     layout: str = "dense", logical_k: int | None = None,
                     col_ids=None, window_block: int | None = None,
                     mode: str = "folded",
                     sms: int = placed_gemm.SMS) -> list[TunedPlan]:
    """The candidates the contract checker (``analysis/contracts``)
    accepts for this call (``col_ids`` a tensor or a column count): every
    plan the tuner times has passed the same invariants as the kernel's
    own check."""
    from repro_torch.analysis.contracts import check_tile_plan
    from repro_torch.analysis.errors import ContractViolation

    n_cols = col_ids if col_ids is None or isinstance(col_ids, int) \
        else int(col_ids.shape[-1])
    out = []
    for plan in plans:
        try:
            check_tile_plan(plan, entry, x_shape, planes_shape,
                            layout=layout, logical_k=logical_k,
                            col_ids=n_cols, window_block=window_block,
                            mode=mode, sms=sms)
        except ContractViolation:
            continue
        out.append(plan)
    return out


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """One tuning run: the winning plan and the evidence."""

    key: str
    plan: TunedPlan
    tuned_s: float
    heuristic_s: float
    n_candidates: int

    @property
    def speedup(self) -> float:
        return self.heuristic_s / self.tuned_s if self.tuned_s > 0 else 1.0

    def to_stats(self) -> dict:
        return {"tuned_s": self.tuned_s, "heuristic_s": self.heuristic_s,
                "speedup": self.speedup, "n_candidates": self.n_candidates}


def tune_kernel(entry: str, x: torch.Tensor, planes: torch.Tensor, *,
                col_ids: torch.Tensor | None = None,
                window_block: int | None = None, layout: str = "dense",
                logical_k: int | None = None, mode: str = "folded",
                backend: str = "cuda", warmup: int = 1, reps: int = 5,
                max_candidates: int = MAX_CANDIDATES) -> TuneResult:
    """Time every valid candidate on the card on real operands; return the
    fastest.

    ``x`` [B, K] int8 and the pack's planes (and ``col_ids`` for a placed
    pack) must lie on a CUDA device.  The heuristic plan is timed first,
    so the winner is never slower than it as measured here; every other
    candidate's output must equal the heuristic's bit for bit, else
    ``ContractViolation``.
    """
    from repro_torch.analysis.errors import ContractViolation

    if not x.is_cuda:
        raise RuntimeError(
            f"tune_kernel: x is on {x.device}: there is no kernel to tune "
            "there (the plain versions take no launch plan); tune on a "
            "CUDA device")
    if entry not in ("gemv", "gemm"):
        raise ContractViolation("autotune", "entry",
                                f"unknown entry {entry!r}")
    b, k = int(x.shape[0]), int(x.shape[1])
    wb = int(planes.shape[0])
    placed = col_ids is not None
    n = int(col_ids.shape[-1]) if placed else int(planes.shape[-1])
    key = tuning_key(entry, b, k, n, wb, layout, placed)
    sms = devices.sm_count(x.device)
    plans = candidate_plans(
        entry, b, k, n, layout=layout,
        placed_window=int(planes.shape[-1]) if placed else None,
        pack_window_block=window_block, wb=wb, mode=mode, sms=sms)
    plans = valid_candidates(
        plans, entry, x.shape, planes.shape, layout=layout,
        logical_k=logical_k, col_ids=col_ids, window_block=window_block,
        mode=mode, sms=sms)[:max_candidates]
    if not plans or not plans[0].is_default():
        raise ContractViolation(
            "autotune", "tile-plan",
            f"the heuristic plan is invalid for {key}: the fallback itself "
            "breaks a kernel contract")

    be = get_backend(backend)

    def run(plan: TunedPlan):
        kw = {"layout": layout, "logical_k": logical_k}
        if not plan.is_default():
            kw["tile_plan"] = plan
        m = plan.mode or mode
        if placed:
            fn = be.matmul_placed if entry == "gemm" else be.gemv_placed
            return fn(x, planes, col_ids, m, window_block=window_block, **kw)
        fn = be.matmul if entry == "gemm" else be.gemv
        return fn(x, planes, m, **kw)

    best, oracle, heuristic_s = None, None, None
    for plan in plans:
        t, out = median_time(lambda p=plan: run(p), x.device, warmup=warmup,
                             reps=reps)
        if oracle is None:
            oracle, heuristic_s = out, t
        elif not torch.equal(out, oracle):
            raise ContractViolation(
                "autotune", "bit-exactness",
                f"candidate {plan.to_dict()} for {key} differs from the "
                "heuristic plan's output")
        if best is None or t < best[0]:
            best = (t, plan)
    return TuneResult(key=key, plan=best[1], tuned_s=best[0],
                      heuristic_s=heuristic_s, n_candidates=len(plans))
