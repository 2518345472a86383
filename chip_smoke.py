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
     read after each drive;
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
  9. each kernel at the main path's shapes against its plain version on the
     card (exact equality, both modes), timed with CUDA events (median of 30
     launches, L2 flushed before each) beside its bound and a library
     yardstick (``torch._int_mm`` on the unpacked signed weights, with x
     zero-padded to 32 rows where it has fewer);
 10. print the ``kernels`` JSON line and, last, the device JSON line.

It needs the port's sources beside it (``src/repro_torch``) and a GPU.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

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
    (CUDA events); on a CPU rehearsal, the host clock."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if flush.is_cuda:
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
    dense = unpack_plane_words(pt.planes, pt.logical_k)
    if pt.col_ids is not None:
        dense = dense[:, :, window_cols(pt.col_ids, pt.planes.shape[-1],
                                        pt.window_block)]
    return signed_weights(dense).to(dense.dtype).contiguous()   # int8


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


def profile_step(torch, model, params, tokens, max_len, sync) -> None:
    """Host wall time of one decode step and, from ``torch.profiler``, the
    device time it launched, by kernel."""
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


def run(torch, dev, preset: str = "full", grid: dict = GRID) -> dict:
    """All phases on ``dev``.  ``main`` runs them on the GPU at full
    width; a CPU rehearsal (``dev`` cpu, smoke preset, small grid) runs the
    same control flow through the plain versions, without the launch-count
    checks and the library yardstick."""
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import (FleetConfig, calibrate_fleet,
                                        ladder_tables, manufacture_fleet)
    from repro_torch.core.rng import generator
    from repro_torch.kernels import build, calib_iter, placed_gemm, plane_gemm
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
               "gemm": plane_gemm.gemm, "gemv": plane_gemm.gemv}

    if on_card:
        phase("build")
        t0 = time.perf_counter()
        libs = build.build_all()
        print(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f}s "
              f"under {build.build_dir().relative_to(ROOT)}")
        for name in build.SOURCES:
            for line in build.ptxas_report(name).splitlines():
                if "Used" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

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

    for rows_ in (BATCH, 1):
        phase(f"profile: one batch-{rows_} placed decode step")
        profile_step(torch, res["model"], packed.params,
                     res["tokens"][:rows_], res["max_len"], sync)

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
        return dict(
            shape=f"x [{b},{pt.k}] x words {list(pt.planes.shape)}, N {n}",
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

    wi, wo, un = layer0(packed, "wi"), layer0(packed, "wo"), \
        packed.tensor("unembed/w")
    src = "src/repro_torch/csrc/placed_gemm.cu"
    rows.append(dict(
        name="gemm_placed", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemm.py:166",
        launches=launches["gemm_placed"],
        **gemm_row(placed_gemm.gemm_placed, placed_gemm.gemm_placed_plain,
                   wi, BATCH * PROMPT),
        extra_shapes=[gemm_row(placed_gemm.gemm_placed,
                               placed_gemm.gemm_placed_plain, wo, BATCH)]))
    rows.append(dict(
        name="gemv_placed", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemv.py:377",
        launches=launches["gemv_placed"],
        **gemm_row(placed_gemm.gemv_placed, placed_gemm.gemv_placed_plain,
                   un, 1)))

    uwi, uwo, uun = layer0(upacked, "wi"), layer0(upacked, "wo"), \
        upacked.tensor("unembed/w")
    src = "src/repro_torch/csrc/plane_gemm.cu"
    rows.append(dict(
        name="gemm", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemm.py:105",
        launches=launches["gemm"],
        **gemm_row(plane_gemm.gemm, plane_gemm.gemm_plain, uwi,
                   BATCH * PROMPT),
        extra_shapes=[gemm_row(plane_gemm.gemm, plane_gemm.gemm_plain, pt,
                               ENGINE_SLOTS) for pt in (uwo, uun)]))
    rows.append(dict(
        name="gemv", route="cuda", source=src,
        replaces="src/repro/kernels/bitplane_gemv.py:316",
        launches=launches["gemv"],
        **gemm_row(plane_gemm.gemv, plane_gemm.gemv_plain, uun, 1)))

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
    return {"rows": rows, "mean_ecr": mean_ecr, "occupancy": occupancy}


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
         **({"extra_shapes": [{k: e[k] for k in (
             "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")} for e in r["extra_shapes"]]}
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
