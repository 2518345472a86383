"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold every hand-written
kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):

  1. print the card (``nvidia-smi --query-gpu=name,power.limit``);
  2. build ``src/repro_torch/csrc/*.cu`` with nvcc (one process per source,
     in parallel) and print each kernel's register / spill report;
  3. the main path at full width, through the serving entry point:
     qwen3-1.7b (28 layers, d 2048, d_ff 6144, vocab 151936, random weights
     from a seed) on a 1 x 1 x 16 x 65,536 subarray grid: calibration with
     the ``calib_iter`` kernel, ECR masks, placement, placed bit-plane packs,
     greedy decode of 4 prompts of 32 tokens for 16 tokens with every FFN and
     unembed projection in the placed GEMM kernels; then one batch-1 request
     (placed GEMV kernel in decode); launch counters are zeroed before and
     read after each drive; profiles of one batch-4 and one batch-1 placed
     decode step print the placed GEMM kernels' device time per step;
  4. the whole-model check: prefill logits through the kernels equal, bit
     for bit, the same packs run through the plain versions on the card;
  5. the calibration check: the main run's calibrated levels (12 kernel
     launches over the whole grid) equal ``calibrate_fleet`` through the
     plain version on the card, from the same seed;
  6. reopen the session on the same cache: table HIT and placement HIT;
  7. the unplaced engine path at full width, through the serving entry
     point: ``--pud-gemv --calib-cache <the same cache> --no-placement
     --engine`` with 8 prompts on 4 engine slots, every packed projection in
     the unplaced GEMM/GEMV kernels and none in the placed ones; then one
     batch-1 request on the unplaced packs (unplaced GEMV decode) and a
     profile of one batch-4 unplaced decode step;
  8. a ragged engine run (12 requests, prompts of 8 to 128 tokens, budgets
     of 4 to 32) through the kernels and again through the plain versions
     with the same schedule: tokens equal, logits bit for bit;
  9. the paper's Table I at its own scales: ``evaluate_method`` for B300
     and T210 (Algorithm 1 on a 65,536-column subarray, 8,192 MAJ5 trials,
     ADD8 / MUL8 graph ECR on 4,096 columns at 512 / 128 trials), each
     number beside the paper's and each stage's wall time; then the
     quickstart's ``PUDSession.baseline_ecr()`` and ``calibrate()``;
 10. the command-level simulator at paper width: 256 MAJ5 events on one
     65,536-column subarray built from ``write_row`` / ``frac`` / ``simra``
     commands (one ``majx_sense`` launch each), whose ECR must agree with
     ``measure_ecr_maj5`` on the same offsets within a binomial tolerance;
 11. the dense plane layout (the reference's default) through the ``ops``
     entries at the reference kernel benchmark's shapes (B 8 and B 1,
     K = N = 2048, 4-bit): every GEMM/GEMV entry launches its kernel;
 12. each kernel at the main path's shapes against its plain version on the
     card (exact equality, both modes), timed with CUDA events (median of 30
     launches, L2 flushed before each, the host's launch time hidden behind
     a spin on the card) beside its bound and a library
     yardstick (``torch._int_mm`` on the unpacked signed weights, with x
     zero-padded to 32 rows where it has fewer; none for the sensing
     kernel); the dense layout as extra shapes of the GEMM rows; each
     placed shape prints its launch plan (dp4a or tensor cores, grid, K
     split, stage, shared memory);
 13. print the ``kernels`` JSON line and, last, the device JSON line.

It needs the port's sources beside it (``src/repro_torch``) and a GPU.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_S = 1979e12         # dense int8 tensor-core rate
F32_OPS_S = 67e12            # float32 outside the tensor cores
ARCH = "qwen3-1.7b"
GRID = dict(n_channels=1, n_banks=1, n_subarrays=16, n_cols=65536)
BATCH, PROMPT, GEN, SEED = 4, 32, 16, 0
ENGINE_BATCH, ENGINE_SLOTS = 8, 4
RAGGED = dict(n=12, prompt=(8, 128), budget=(4, 32))
LIB_ROWS = 32                # torch._int_mm takes more than 16 rows
# benchmarks/table1.py's scales (the reference's evaluate_method defaults)
TABLE1 = dict(n_cols=65536, n_trials_maj5=8192, n_cols_arith=4096,
              n_trials_arith=512)
PAPER = {"B300": dict(ecr=0.466, maj5=0.89e12, add=50.2e9, mul=5.8e9),
         "T210": dict(ecr=0.033, maj5=1.62e12, add=94.6e9, mul=11.0e9),
         "gain": dict(maj5=1.81, add=1.88, mul=1.89)}
QUICKSTART = dict(n_channels=1, n_banks=1, n_subarrays=2, n_cols=4096)
SIMRA = dict(n_cols=65536, events=256)
DENSE = dict(b=8, k=2048, n=2048, wb=4)   # benchmarks/kernel_bench.py
# majx_sense rows (T, R, C, n_fracs): the simulator's own event, one ECR
# chunk of a DDR4 row, kernel_bench.py's shape, and a ragged one
SENSE_SHAPES = [(1, 8, SIMRA["n_cols"], 3), (256, 8, 65536, 3),
                (256, 8, 65536, 0), (16, 8, 4096, 0), (16, 8, 4096, 3),
                (13, 8, 65000, 3)]


class PhaseError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase(name: str):
    print(f"== {name}", flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    need(r.returncode == 0 and r.stdout.strip(),
         f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 30) -> float:
    """Median device time of one call in ms, L2 flushed before each launch
    (CUDA events); on a CPU rehearsal, the host clock.  A spin of about
    0.3 ms queued after the flush keeps the card busy while the host runs
    the wrapper, so the host's time to launch does not count as the
    kernel's."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if flush.is_cuda:
            torch.cuda._sleep(500_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def reset_counts(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0


def read_counts(kernels) -> dict:
    return {name: fn.launches for name, fn in kernels.items()}


def restamp(tree, backend: str):
    """The packed tree with every pack stamped to run through ``backend``."""
    from repro_torch.pud.packed import PackedTensor
    if isinstance(tree, dict):
        return {k: restamp(v, backend) for k, v in tree.items()}
    if isinstance(tree, PackedTensor):
        return tree.replace(backend=backend)
    return tree


def library_weights(pt):
    """[K, N] int8 signed weights of a pack (placed: its logical columns),
    the operand of the library yardstick."""
    from repro_torch.kernels.placed_gemm import window_cols
    from repro_torch.kernels.ref import signed_weights, unpack_plane_words
    dense = pt.planes
    if pt.layout == "bitpack8":
        dense = unpack_plane_words(pt.planes, pt.logical_k)
    if pt.col_ids is not None:
        dense = dense[:, :, window_cols(pt.col_ids, pt.planes.shape[-1],
                                        pt.window_block)]
    return signed_weights(dense).to(dense.dtype).contiguous()   # int8


def dense_pack(pt):
    """The same pack in the dense layout (one int8 byte per bit), built
    here as a test operand: the wrappers never repack."""
    from repro_torch.kernels.ref import unpack_plane_words
    return types.SimpleNamespace(
        k=pt.k, n=pt.n, layout="dense", logical_k=None,
        planes=unpack_plane_words(pt.planes, pt.logical_k).contiguous(),
        col_ids=pt.col_ids, window_block=pt.window_block)


def kernel_name(mangled: str) -> str:
    """A readable name of a mangled kernel: its name (the identifier after
    its length) and its template arguments (``dp4a_kernel<4, false>``)."""
    import re
    for m in re.finditer(r"\d+", mangled):
        lengths = {int(m.group()[i:]) for i in range(len(m.group()))}
        name = next((mangled[m.end():m.end() + n] for n in sorted(lengths)
                     if mangled[m.end():m.end() + n].endswith("kernel")),
                    "")
        if name:
            rest = mangled[m.end() + len(name):]
            args = [v if k == "i" else ("true" if v == "1" else "false")
                    for k, v in re.findall(r"L([bi])(\d+)E",
                                           rest.split("EEv")[0])]
            return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


def placed_plan(pt, b: int) -> str:
    """The launch plan of a placed pack at B rows, as the wrapper makes it."""
    from repro_torch.kernels.placed_gemm import plan_launch, window_tiling
    wb, _, w_len = pt.planes.shape
    pwb, bc = window_tiling(pt.n, w_len, pt.window_block, "chip_smoke")
    p = plan_launch(b, -(-pt.k // 8), pt.n, wb, pwb, bc,
                    pt.layout == "dense")
    path = "tensor cores" if p.tensor_cores else "dp4a"
    return (f"{path}, {p.rows} rows x {p.tile_cols} columns per block, "
            f"grid {p.grid}, K split {p.n_split} x {p.split_words} words, "
            f"{p.stage_words} words per stage, "
            f"{'staged' if p.staged else 'unstaged'}, "
            f"{p.smem_bytes} B shared")


def finite(*xs) -> bool:
    return all(math.isfinite(x) for x in xs)


def table1_phase(torch, dev, scale: dict, calib=None) -> dict:
    """Paper Table I through ``evaluate_method`` at ``scale``: every number
    beside the paper's, with each stage's wall time."""
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.throughput import evaluate_method
    phase("Table I: evaluate_method B300 and T210 at the paper's scales")
    print(f"  {scale}, {calib or CalibrationConfig()}")
    res = {}
    for name in ("B300", "T210"):
        t0 = time.perf_counter()
        r = evaluate_method(SEED, name, device=dev,
                            calib_config=calib or CalibrationConfig(),
                            **scale)
        wall = time.perf_counter() - t0
        ref = PAPER[name]
        print(f"  {name}: ECR {r.ecr:.4f} (paper {ref['ecr']}), ADD8 ECR "
              f"{r.ecr_add:.4f}, MUL8 ECR {r.ecr_mul:.4f}; MAJ5 "
              f"{r.maj5_tops / 1e12:.4f} TOPS (paper {ref['maj5'] / 1e12}), "
              f"ADD8 {r.add8_gops / 1e9:.3f} GOPS (paper "
              f"{ref['add'] / 1e9}), MUL8 {r.mul8_gops / 1e9:.3f} GOPS "
              f"(paper {ref['mul'] / 1e9})")
        print("    wall: " + ", ".join(f"{k} {v:.3f}s"
                                       for k, v in r.stage_s.items())
              + f"; evaluate_method {wall:.3f}s")
        need(finite(r.ecr, r.ecr_add, r.ecr_mul, r.maj5_tops, r.add8_gops,
                    r.mul8_gops), f"{name}: a Table-I number is not finite")
        res[name] = dict(ecr=r.ecr, ecr_add=r.ecr_add, ecr_mul=r.ecr_mul,
                         maj5_tops=r.maj5_tops, add8_gops=r.add8_gops,
                         mul8_gops=r.mul8_gops, stage_s=r.stage_s, wall_s=wall)
    b, t = res["B300"], res["T210"]
    gains = dict(maj5=t["maj5_tops"] / b["maj5_tops"],
                 add=t["add8_gops"] / b["add8_gops"],
                 mul=t["mul8_gops"] / b["mul8_gops"])
    print("  gains T210/B300: " + ", ".join(
        f"{k.upper()} {v:.3f}x (paper {PAPER['gain'][k]}x)"
        for k, v in gains.items()))
    need(t["ecr"] < b["ecr"], "T210's ECR is not below B300's")
    need(finite(*gains.values()), "a Table-I gain is not finite")
    res["gains"] = gains
    return res


def quickstart_phase(torch, dev, grid: dict) -> dict:
    """examples/quickstart.py's session: B300 baseline, then Algorithm 1."""
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.runtime.session import PUDSession
    phase("quickstart: PUDSession.open(grid).baseline_ecr(), calibrate()")
    t0 = time.perf_counter()
    session = PUDSession.open(FleetConfig(**grid), seed=SEED, device=dev)
    base = session.baseline_ecr()
    tuned = session.calibrate().mean_ecr
    print(f"  grid {grid}: ECR baseline {base:.4f} (paper 0.466), PUDTune "
          f"{tuned:.4f} (paper 0.033), {time.perf_counter() - t0:.3f}s")
    need(finite(base, tuned) and tuned < base,
         "the quickstart's calibration did not lower the ECR")
    return dict(baseline=base, tuned=tuned)


def simra_phase(torch, dev, cfg: dict, counter) -> dict:
    """MAJ5 through the command-level simulator: per event, five operand
    rows, the B_{3,0,0} rows built with commands (a 1 row Frac'd three
    times, a 0 row, a 1 row) and one ``simra`` over the eight rows.  Its
    ECR must agree with ``measure_ecr_maj5`` on the same offsets: both are
    means over the columns of independent per-column error events, so they
    may differ by 4 sigma of a binomial share, 4 sqrt(2 e (1 - e) / C)."""
    from repro_torch.core.ecr import measure_ecr_maj5
    from repro_torch.core.offsets import baseline_charges
    from repro_torch.core.rng import generator
    from repro_torch.pud import device as pud
    from repro_torch.pud.physics import PhysicsParams
    n, events = cfg["n_cols"], cfg["events"]
    phase(f"command-level MAJ5: {events} SiMRA events on one {n}-column "
          "subarray")
    p = PhysicsParams()
    pud.set_params(p)
    gen = generator(SEED, "simra", device=dev)
    state = pud.make_subarray(gen, 8, n, p, device=dev)
    ones = torch.ones(n, device=dev)
    any_err = torch.zeros(n, dtype=torch.bool, device=dev)
    counter.launches = 0
    t0 = time.perf_counter()
    for _ in range(events):
        bits = torch.randint(0, 2, (5, n), generator=gen, device=dev,
                             dtype=torch.uint8)
        for r in range(5):
            state = pud.write_row(state, r, bits[r])
        state = pud.write_row(state, 5, ones)
        for _ in range(3):
            state = pud.frac(state, 5)
        state = pud.write_row(state, 6, torch.zeros_like(ones))
        state = pud.write_row(state, 7, ones)
        state, out = pud.simra(state, range(8), gen, 3)
        any_err |= out != (bits.sum(dim=0) > 2).to(torch.float32)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    need(launches == events or dev.type != "cuda",
         f"{events} SiMRA events launched majx_sense {launches} times")
    cmd = float(any_err.float().mean())
    fast, _ = measure_ecr_maj5(generator(SEED, "simra-ecr", device=dev),
                               state.sense_offset,
                               baseline_charges(3, n, p, device=dev), p, 3,
                               n_trials=events)
    e = (cmd + fast) / 2
    tol = 4 * math.sqrt(2 * e * (1 - e) / n)
    print(f"  ECR over {events} trials: command level {cmd:.4f}, "
          f"measure_ecr_maj5 {fast:.4f}, |diff| {abs(cmd - fast):.4f} "
          f"(tolerance {tol:.4f}); {launches} majx_sense launches, "
          f"{wall:.3f}s")
    need(abs(cmd - fast) <= tol, "command-level ECR disagrees with "
         "measure_ecr_maj5")
    return dict(ecr_cmd=cmd, ecr_fast=fast, tol=tol, launches=launches)


def dense_phase(torch, dev, cfg: dict, kernels) -> dict:
    """The dense plane layout through the ``ops`` entries at the reference
    kernel benchmark's shapes: GEMM entries at B rows, GEMV entries at one,
    both modes, each equal to the integer product."""
    from repro_torch.core.rng import generator
    from repro_torch.kernels import ops, ref
    b, k, n, wb = cfg["b"], cfg["k"], cfg["n"], cfg["wb"]
    phase(f"dense layout through ops: x [{b} | 1, {k}] x planes "
          f"[{wb}, {k}, {n}] int8")
    g = generator(SEED, "dense", device=dev)
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (k, n), generator=g,
                      device=dev, dtype=torch.int32)
    planes = ref.pack_bitplanes(w, wb)
    # a placed window: blocks of 256 logical columns among 288 window columns
    bc, pwb = 256, 288
    cols = torch.cat([j * pwb + torch.randperm(pwb, generator=g,
                                               device=dev)[:bc]
                      for j in range(n // bc)]).to(torch.int32)
    window = torch.zeros((wb, k, (n // bc) * pwb), dtype=torch.int8,
                         device=dev)
    window[:, :, cols.long()] = planes
    x = torch.randint(-127, 128, (b, k), generator=g, device=dev,
                      dtype=torch.int8)
    reset_counts(kernels)
    for mode in ("planes", "folded"):
        for xb, entries in ((x[:1].contiguous(), ("gemv", "gemv_placed")),
                            (x, ("gemm", "gemm_placed"))):
            want = (xb.double() @ w.double()).to(torch.int32)
            unplaced = getattr(ops, f"bitplane_{entries[0]}")(xb, planes,
                                                              mode)
            placed = getattr(ops, f"bitplane_{entries[1]}")(
                xb, window, cols, mode, window_block=pwb)
            need(torch.equal(unplaced, want) and torch.equal(placed, want),
                 f"dense {entries} ({mode}) differ from x @ W")
    xf = torch.randn((b, k), generator=g, device=dev)
    scale = torch.rand(n, generator=g, device=dev) + 0.01
    for xi in (xf, xf[0]):
        got = ops.pud_gemv(xi, planes, scale)
        want = ops.pud_gemv(xi, planes, scale, backend="reference")
        need(torch.equal(got, want), "dense pud_gemv differs from the "
             "reference backend")
    counts = {e: kernels[e].launches
              for e in ("gemm", "gemv", "gemm_placed", "gemv_placed")}
    print(f"  launches: {counts}; every entry == x @ W")
    need(all(v > 0 for v in counts.values()) or dev.type != "cuda",
         "a dense entry never launched its kernel")
    pack = types.SimpleNamespace(k=k, n=n, layout="dense", logical_k=None,
                                 planes=planes, col_ids=None,
                                 window_block=None)
    placed_pack = types.SimpleNamespace(k=k, n=n, layout="dense",
                                        logical_k=None, planes=window,
                                        col_ids=cols, window_block=pwb)
    return dict(launches=counts, pack=pack, placed_pack=placed_pack)


def ragged_requests(torch, vocab: int):
    """RAGGED["n"] requests with prompt lengths and budgets drawn from the
    seed, so buckets differ and slots are admitted mid-run."""
    from repro_torch.core.rng import generator
    from repro_torch.runtime.engine import Request
    g = generator(SEED, "ragged")
    (p0, p1), (b0, b1) = RAGGED["prompt"], RAGGED["budget"]
    lens = torch.randint(p0, p1 + 1, (RAGGED["n"],), generator=g).tolist()
    budgets = torch.randint(b0, b1 + 1, (RAGGED["n"],), generator=g).tolist()
    return [Request(i, torch.randint(0, vocab, (n,), generator=g,
                                     dtype=torch.int32), m)
            for i, (n, m) in enumerate(zip(lens, budgets))]


def profile_step(torch, model, params, tokens, max_len, sync,
                 placed_was=None) -> None:
    """Host wall time of one decode step and, from ``torch.profiler``, the
    device time it launched, by kernel; ``placed_was``: PR 13's placed GEMM
    device time per step, printed beside the placed kernels' sum."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens, max_len=max_len)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos = tokens.shape[1]
        for _ in range(2):
            model.decode_step(params, cache, nxt, pos)
        sync()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            model.decode_step(params, cache, nxt, pos)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        acts = [ProfilerActivity.CPU]
        if tokens.is_cuda:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            model.decode_step(params, cache, nxt, pos)
            sync()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    wall = statistics.median(walls)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"  decode step (batch {tokens.shape[0]}): host wall "
          f"{wall:.3f} ms (median of 5)")
    if not rows:
        print("  device time: not measured (the profiler reported none)")
        return
    print(f"  device time {busy:.3f} ms ({busy / wall:.1%} of the wall "
          "step); by kernel:")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"    {dev_us / 1e3:8.3f} ms  x{count:<5d} {key[:70]}")
    if placed_was is not None:
        gemm = [(d, c) for d, c, k in rows
                if "dp4a_kernel" in k or "mma_kernel" in k]
        print(f"  placed GEMM kernels: {sum(d for d, _ in gemm) / 1e3:.3f} "
              f"ms over {sum(c for _, c in gemm)} launches per step "
              f"(PR 13's placed_kernel: {placed_was} ms)")


def run(torch, dev, preset: str = "full", grid: dict = GRID,
        table1: dict = TABLE1, table1_calib=None,
        quickstart: dict = QUICKSTART, simra: dict = SIMRA,
        dense_cfg: dict = DENSE, sense_shapes=SENSE_SHAPES) -> dict:
    """All phases on ``dev``.  ``main`` runs them on the GPU at full
    width; a CPU rehearsal (``dev`` cpu, smoke preset, small grid and
    Table-I scales) runs the same control flow through the plain versions,
    without the launch-count checks and the library yardstick."""
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import (FleetConfig, calibrate_fleet,
                                        ladder_tables, manufacture_fleet)
    from repro_torch.core.rng import generator
    from repro_torch.kernels import (build, calib_iter, placed_gemm,
                                     plane_gemm, sense)
    from repro_torch.launch import serve
    from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
    from repro_torch.pud.physics import PhysicsParams
    from repro_torch.runtime.engine import ServingEngine
    from repro_torch.runtime.session import PUDSession

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kernels = {"calib_iter": calib_iter.calib_iter,
               "gemm_placed": placed_gemm.gemm_placed,
               "gemv_placed": placed_gemm.gemv_placed,
               "gemm": plane_gemm.gemm, "gemv": plane_gemm.gemv,
               "majx_sense": sense.majx_sense}

    if on_card:
        phase("build")
        t0 = time.perf_counter()
        libs = build.build_all()
        print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
              f"under {build.build_dir().relative_to(ROOT)}")
        for name in build.SOURCES:
            kernel = ""
            for line in build.ptxas_report(name).splitlines():
                if "Function properties for" in line:
                    kernel = kernel_name(line.split()[-1])
                elif "Used" in line or "spill" in line:
                    print(f"  {name} {kernel}: {line.strip()}")

    phase("main path: calibrate -> place -> pack -> placed decode")
    cache = tempfile.TemporaryDirectory(prefix="pud-cache-")
    argv = ["--arch", ARCH, "--preset", preset, "--pud-gemv",
            "--calib-cache", cache.name,
            "--fleet-subarrays", str(grid["n_subarrays"]),
            "--fleet-cols", str(grid["n_cols"]), "--batch", str(BATCH),
            "--prompt-len", str(PROMPT), "--gen", str(GEN),
            "--seed", str(SEED), "--device", str(dev)]
    reset_counts(kernels)
    res = serve.run(serve.parse_args(argv))
    sync()
    counts = read_counts(kernels)
    session, packed = res["session"], res["packed"]
    print(f"  launches: {counts}")
    need(counts["calib_iter"] > 0 or not on_card,
         "calibration never launched calib_iter")
    need(not session.calibration.cache_hit, "fresh cache reported a hit")
    need(session.placement_status == "planned",
         f"placement {session.placement_status}: {session.placement_error}")
    need(counts["gemm_placed"] > 0 or not on_card,
         "decode never launched gemm_placed")
    need(counts["gemm"] == counts["gemv"] == 0,
         "the placed path launched an unplaced kernel")
    logits, toks = res["logits"], res["toks"]
    vocab = res["model"].cfg.vocab
    need(tuple(logits.shape) == (BATCH, GEN + 1, vocab)
         and bool(torch.isfinite(logits).all()), "bad packed logits")
    need(int(toks.min()) >= 0 and int(toks.max()) < vocab, "bad tokens")
    occupancy = session.placement.occupancy
    mean_ecr = session.calibration.mean_ecr
    print(f"  mean ECR {mean_ecr:.4f}, occupancy {occupancy:.4f}, "
          f"token agreement vs bf16 {res['agreement']:.4f}")

    phase("main path: one batch-1 request (placed GEMV decode)")
    reset_counts(kernels)
    one, _ = serve.greedy_generate(res["model"], packed.params,
                                   res["tokens"][:1], GEN, res["max_len"])
    sync()
    counts1 = read_counts(kernels)
    print(f"  launches: {counts1}")
    need(counts1["gemv_placed"] > 0 or not on_card,
         "B=1 decode never launched gemv_placed")
    need(tuple(one.shape) == (1, GEN), "bad batch-1 tokens")
    launches = {k: counts[k] + counts1[k] for k in counts}

    for rows_, was in ((BATCH, 5.6), (1, 3.3)):
        phase(f"profile: one batch-{rows_} placed decode step")
        profile_step(torch, res["model"], packed.params,
                     res["tokens"][:rows_], res["max_len"], sync, was)

    phase("whole-model check: kernels vs plain versions on the card")
    with torch.inference_mode():
        model = res["model"]
        got, _ = model.prefill(packed.params, res["tokens"],
                               max_len=res["max_len"])
        want, _ = model.prefill(restamp(packed.params, "reference"),
                                res["tokens"], max_len=res["max_len"])
    need(torch.equal(got, want),
         "prefill logits through the kernels differ from the plain path")
    print(f"  prefill logits {list(got.shape)}: kernels == plain versions, "
          "bit for bit")

    phase("calibration check: the main run's levels vs the plain version")
    p = PhysicsParams()
    fcfg = FleetConfig(**grid)
    ccfg = CalibrationConfig(n_iterations=12, n_samples=256)
    offs = manufacture_fleet(SEED + 2, fcfg, p, device=dev)
    want_levels = calibrate_fleet(SEED + 2, offs, fcfg, p, ccfg,
                                  method="reference").levels
    need(torch.equal(session.calibration.levels, want_levels),
         "calibrated levels through calib_iter differ from the plain path")
    print(f"  levels {list(want_levels.shape)} after "
          f"{ccfg.n_iterations} iterations: kernel == plain version")
    del offs, want_levels

    phase("reopen: cache hits")
    cfg = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE)
    again = PUDSession.open(
        ARCH, grid=fcfg, cache_dir=cache.name, calib=ccfg,
        seed=SEED + 2, device=dev)
    st = again.calibrate()
    packed2 = again.pack(res["params"], cfg, name=f"{ARCH}-{preset}")
    need(st.cache_hit, "reopened session missed the calibration table")
    need(again.placement_status == "hit",
         f"reopened placement {again.placement_status}")
    need(torch.equal(packed2.tensor("unembed/w").planes,
                     packed.tensor("unembed/w").planes),
         "reopened packs differ")
    print(f"  table HIT in {st.wall_s:.2f}s, placement HIT "
          f"[{again.placement_name}]")
    del again, packed2

    phase("unplaced engine path: --no-placement --engine, unplaced kernels")
    argv_u = ["--arch", ARCH, "--preset", preset, "--pud-gemv",
              "--calib-cache", cache.name, "--no-placement", "--engine",
              "--fleet-subarrays", str(grid["n_subarrays"]),
              "--fleet-cols", str(grid["n_cols"]),
              "--batch", str(ENGINE_BATCH), "--batch-size",
              str(ENGINE_SLOTS), "--prompt-len", str(PROMPT),
              "--gen", str(GEN), "--seed", str(SEED), "--device", str(dev)]
    reset_counts(kernels)
    ures = serve.run(serve.parse_args(argv_u))
    sync()
    ucounts = read_counts(kernels)
    usession, upacked, model = ures["session"], ures["packed"], ures["model"]
    print(f"  launches: {ucounts}")
    need(usession.calibration.cache_hit, "unplaced run missed the table")
    need(usession.placement_status is None and not upacked.placed,
         f"--no-placement placed the packs ({usession.placement_status})")
    need(ucounts["gemm"] > 0 or not on_card,
         "the unplaced engine path never launched gemm")
    need(ucounts["gemm_placed"] == ucounts["gemv_placed"] == 0,
         "the unplaced path launched a placed kernel")
    comps = ures["completions"]
    need(len(comps) == ENGINE_BATCH
         and all(len(c.tokens) == GEN for c in comps),
         "the engine did not complete every request with its budget")
    need(all(0 <= t < vocab for c in comps for t in c.tokens), "bad tokens")
    sched = ures["sched"]
    print(f"  engine: {sched['steps']} steps on {sched['batch_size']} slots, "
          f"slot occupancy {sched['slot_occupancy']:.4f}, decode wall "
          f"{sched['wall_tok_s']:.1f} tok/s; batched vs lockstep "
          f"{ures['engine_agreement']:.4f} of requests bit-identical")

    phase("unplaced: one batch-1 request (unplaced GEMV decode)")
    reset_counts(kernels)
    one_u, _ = serve.greedy_generate(model, upacked.params,
                                     ures["tokens"][:1], GEN,
                                     ures["max_len"])
    sync()
    ucounts1 = read_counts(kernels)
    print(f"  launches: {ucounts1}")
    need(ucounts1["gemv"] > 0 or not on_card,
         "B=1 decode never launched gemv")
    need(ucounts1["gemm_placed"] == ucounts1["gemv_placed"] == 0,
         "the unplaced path launched a placed kernel")
    need(tuple(one_u.shape) == (1, GEN), "bad batch-1 tokens")
    for k in ("gemm", "gemv"):
        launches[k] = ucounts[k] + ucounts1[k]

    phase("profile: one batch-4 unplaced decode step")
    profile_step(torch, model, upacked.params, ures["tokens"][:BATCH],
                 ures["max_len"], sync)

    phase("ragged engine run: kernels vs plain versions, same schedule")
    reqs = ragged_requests(torch, vocab)
    r_len = RAGGED["prompt"][1] + RAGGED["budget"][1]
    eng = usession.serving_engine(model, max_len=r_len,
                                  batch_size=ENGINE_SLOTS,
                                  collect_logits=True)
    eng_ref = ServingEngine(model, restamp(upacked.params, "reference"),
                            session=usession, max_len=r_len,
                            batch_size=ENGINE_SLOTS, collect_logits=True)
    got_c, want_c = eng.run(reqs), eng_ref.run(reqs)
    sync()
    for g_, w_ in zip(got_c, want_c):
        need(g_.tokens == w_.tokens and torch.equal(g_.logits, w_.logits)
             and (g_.slot, g_.admitted_step) == (w_.slot, w_.admitted_step),
             f"request {g_.request_id}: kernels differ from plain versions")
    rsched = eng.scheduler_report()
    need(len(got_c) == RAGGED["n"] and rsched["prefill_traces"] > 1
         and max(c.admitted_step for c in got_c) > 0,
         "the ragged run did not exercise buckets and mid-run admission")
    print(f"  {len(got_c)} requests, {rsched['generated_tokens']} tokens in "
          f"{rsched['steps']} steps, {rsched['prefill_traces']} prefill "
          f"buckets, occupancy {rsched['slot_occupancy']:.4f}: tokens and "
          "logits through the kernels == plain versions, bit for bit")
    del eng, eng_ref, got_c, want_c

    del res, ures
    cache.cleanup()

    t1 = table1_phase(torch, dev, table1, table1_calib)
    qs = quickstart_phase(torch, dev, quickstart)
    sim = simra_phase(torch, dev, simra, sense.majx_sense)
    launches["majx_sense"] = sim["launches"]
    dense = dense_phase(torch, dev, dense_cfg, kernels)

    phase("kernels vs plain versions at the main path's shapes")
    flush = torch.empty((256 if on_card else 1) * 2**20, dtype=torch.uint8,
                        device=dev)
    rows = []

    # calib_iter: one launch over the whole grid, as each iteration of the
    # main path makes it: G subarrays x S=256 samples of M=5 operands.
    ladder = fcfg.ladder(p)
    qsum, swing = ladder_tables(ladder, p)
    g, s, m, c = (fcfg.n_subarrays_total, ccfg.n_samples, ccfg.maj_inputs,
                  fcfg.n_cols)
    gen = generator(SEED, "chip-smoke", device=dev)
    bits = torch.randint(0, 2, (g, s, m, c), generator=gen, device=dev,
                         dtype=torch.uint8)
    noise = torch.randn((g, s, c), generator=gen, device=dev)
    levels = torch.randint(0, ladder.n_levels, (g, c), generator=gen,
                           device=dev, dtype=torch.int32)
    offs = manufacture_fleet(SEED, fcfg, p, device=dev)
    cargs = (p, ladder.n_fracs, qsum, swing, ccfg.threshold, m)
    k_l, k_b = calib_iter.calib_iter(bits, noise, levels, offs, *cargs)
    p_l, p_b = calib_iter.calib_iter_plain(bits, noise, levels, offs, *cargs)
    sync()
    need(torch.equal(k_l, p_l) and torch.equal(k_b, p_b),
         "calib_iter differs from its plain version")
    need(bool((k_l != levels).any()), "calib_iter moved no level")
    nbytes = g * (s * m * c + s * c * 4 + 4 * c * 4)
    nops = g * s * c * (m + 10)
    rows.append(dict(
        name="calib_iter", route="cuda",
        source="src/repro_torch/csrc/calib_iter.cu",
        replaces="src/repro/kernels/majx.py:157",
        shape=f"inputs [{g},{s},{m},{c}] u8, noise [{g},{s},{c}]",
        launches=launches["calib_iter"],
        max_abs_err=float((k_b - p_b).abs().max()),
        ms=time_ms(torch, lambda: calib_iter.calib_iter(
            bits, noise, levels, offs, *cargs), flush),
        plain_ms=time_ms(torch, lambda: calib_iter.calib_iter_plain(
            bits, noise, levels, offs, *cargs), flush, reps=10),
        bytes=nbytes, ops=nops,
        bound_by_bytes_ms=nbytes / HBM_BYTES_S * 1e3,
        bound_by_ops_ms=nops / F32_OPS_S * 1e3, library_ms=None))

    # bit-plane GEMM / GEMV on the main path's packs (placed and unplaced).
    gen_x = generator(SEED, "chip-smoke-x", device=dev)

    def sense_row(t, r, c, n_fracs):
        charge = torch.rand((t, r, c), generator=gen_x, device=dev)
        offs = 0.033 * torch.randn(c, generator=gen_x, device=dev)
        noise = torch.randn((t, c), generator=gen_x, device=dev)
        args = (charge, offs, noise, p, n_fracs)
        got = sense.majx_sense(*args)
        want = sense.majx_sense_plain(*args)
        sync()
        need(torch.equal(got, want), f"majx_sense differs from its plain "
             f"version at charge [{t}, {r}, {c}], n_fracs {n_fracs}")
        need(0 < float(want.mean()) < 1, "majx_sense sensed one value")
        nbytes = (t * r * c + 2 * t * c + c) * 4
        nops = t * c * (5 * r + 9)
        return dict(
            shape=f"charge [{t},{r},{c}], n_fracs {n_fracs}",
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(torch, lambda: sense.majx_sense(*args), flush),
            plain_ms=time_ms(torch, lambda: sense.majx_sense_plain(*args),
                             flush, reps=10),
            bytes=nbytes, ops=nops,
            bound_by_bytes_ms=nbytes / HBM_BYTES_S * 1e3,
            bound_by_ops_ms=nops / F32_OPS_S * 1e3, library_ms=None)

    def gemm_row(fn, plain, pt, b):
        x = torch.randint(-127, 128, (b, pt.k), generator=gen_x, device=dev,
                          dtype=torch.int8)
        kw = dict(layout=pt.layout, logical_k=pt.logical_k)
        operands = (pt.planes,)
        if pt.col_ids is not None:
            operands += (pt.col_ids,)
            kw["window_block"] = pt.window_block
        want = plain(x, *operands, "folded", **kw)
        for mode in ("folded", "planes"):
            got = fn(x, *operands, mode, **kw)
            sync()
            need(torch.equal(got, want), f"{fn.__name__} ({mode}) differs "
                 f"from its plain version at x {tuple(x.shape)}")
        wb, kw_words, _ = pt.planes.shape
        n = pt.n
        nbytes = (b * pt.k + wb * kw_words * n + b * n * 4
                  + (n * 4 if pt.col_ids is not None else 0))
        nops = 2 * b * n * pt.k
        lib_ms = None
        if on_card:
            w8 = library_weights(pt)
            xl = x
            if b < LIB_ROWS:
                xl = torch.zeros((LIB_ROWS, pt.k), dtype=torch.int8,
                                 device=dev)
                xl[:b] = x
            need(torch.equal(torch._int_mm(xl, w8)[:b], want),
                 "library yardstick disagrees")
            lib_ms = time_ms(torch, lambda: torch._int_mm(xl, w8), flush)
            del w8
        plan = placed_plan(pt, b) if pt.col_ids is not None else None
        return dict(
            shape=f"x [{b},{pt.k}] x {pt.layout} {list(pt.planes.shape)}, "
                  f"N {n}", layout=pt.layout, plan=plan,
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(torch, lambda: fn(x, *operands, "folded", **kw),
                       flush),
            plain_ms=time_ms(torch, lambda: plain(x, *operands, "folded",
                                                  **kw), flush, reps=10),
            bytes=nbytes, ops=nops,
            bound_by_bytes_ms=nbytes / HBM_BYTES_S * 1e3,
            bound_by_ops_ms=nops / INT8_OPS_S * 1e3, library_ms=lib_ms)

    def layer0(pm, name):
        return pm.tensor(f"layers_0_dense/mixer/{name}").layer(0)

    def dense_rows(entry, fn, plain, b, big):
        """The dense layout on one entry: the ops phase's benchmark pack
        (its launches are that phase's) and a main-path pack ``big``."""
        kb = dense["placed_pack" if "placed" in entry else "pack"]
        return [dict(gemm_row(fn, plain, kb, dense_cfg["b"] if b > 1 else 1),
                     launches=dense["launches"][entry]),
                dict(gemm_row(fn, plain, big, b),
                     launches=dense["launches"][entry])]

    wi, wo, un = layer0(packed, "wi"), layer0(packed, "wo"), \
        packed.tensor("unembed/w")
    dun = dense_pack(un)
    src = "src/repro_torch/csrc/placed_gemm.cu"
    rows.append(dict(
        name="gemm_placed", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemm.py:166",
        launches=launches["gemm_placed"],
        **gemm_row(placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain,
                   wi, BATCH * PROMPT),
        extra_shapes=[gemm_row(placed_gemm.gemm_placed,
                               placed_gemm.gemm_placed_plain, pt, BATCH)
                      for pt in (wi, wo)]
        + dense_rows("gemm_placed", placed_gemm.gemm_placed,
                     placed_gemm.gemm_placed_plain, BATCH, dun)))
    rows.append(dict(
        name="gemv_placed", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemv.py:377",
        launches=launches["gemv_placed"],
        **gemm_row(placed_gemm.gemv_placed, placed_gemm.gemv_placed_plain,
                   un, 1),
        extra_shapes=dense_rows("gemv_placed", placed_gemm.gemv_placed,
                                placed_gemm.gemv_placed_plain, 1, dun)))
    del dun

    uwi, uwo, uun = layer0(upacked, "wi"), layer0(upacked, "wo"), \
        upacked.tensor("unembed/w")
    duun = dense_pack(uun)
    src = "src/repro_torch/csrc/plane_gemm.cu"
    rows.append(dict(
        name="gemm", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemm.py:105",
        launches=launches["gemm"],
        **gemm_row(plane_gemm.gemm, plane_gemm.gemm_plain, uwi,
                   BATCH * PROMPT),
        extra_shapes=[gemm_row(plane_gemm.gemm, plane_gemm.gemm_plain, pt,
                               ENGINE_SLOTS) for pt in (uwo, uun)]
        + dense_rows("gemm", plane_gemm.gemm, plane_gemm.gemm_plain,
                     BATCH, duun)))
    rows.append(dict(
        name="gemv", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemv.py:316",
        launches=launches["gemv"],
        **gemm_row(plane_gemm.gemv, plane_gemm.gemv_plain, uun, 1),
        extra_shapes=dense_rows("gemv", plane_gemm.gemv,
                                plane_gemm.gemv_plain, 1, duun)))
    del duun

    (t0_, r0_, c0_, f0_), *rest = sense_shapes
    rows.append(dict(
        name="majx_sense", route="cuda",
        source="src/repro_torch/csrc/simra_sense.cu",
        replaces="src/repro/kernels/majx.py:197",
        launches=launches["majx_sense"], **sense_row(t0_, r0_, c0_, f0_),
        extra_shapes=[sense_row(*sh) for sh in rest]))

    for r in [e for row in rows for e in [row] + row.get("extra_shapes", [])]:
        bb, bo = r["bound_by_bytes_ms"], r["bound_by_ops_ms"]
        r["bound_ms"] = max(bb, bo)
        r["bound_by"] = "bytes" if bb >= bo else "operations"
        lib = (f"{r['library_ms']:.4f}" if r["library_ms"] is not None
               else "n/a")
        print(f"  {r.get('name', '  (extra)'):<12s} {r['shape']}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), max |err| {r['max_abs_err']}")
        if r.get("plan"):
            print(f"      plan: {r['plan']}")
    return {"rows": rows, "mean_ecr": mean_ecr, "occupancy": occupancy,
            "table1": t1, "quickstart": qs, "simra": sim}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    t0 = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    try:
        out = run(torch, torch.device("cuda"))
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {**{k: r[k] for k in keys},
         "shape": r["shape"],
         **({"plan": r["plan"]} if r.get("plan") else {}),
         **({"extra_shapes": [{k: e[k] for k in (
             "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "layout", "launches", "plan")
             if k in e and (k != "plan" or e[k])}
             for e in r["extra_shapes"]]}
            if "extra_shapes" in r else {})}
        for r in out["rows"]]}
    print(f"  total wall {time.perf_counter() - t0:.1f}s")
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
