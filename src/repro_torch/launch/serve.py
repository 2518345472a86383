"""Batched serving driver: prefill + greedy decode, optional PUD GEMM path
and continuous-batching engine (port of ``repro/launch/serve.py``: the
``--pud-gemv --calib-cache [--no-placement] [--engine]`` paths and the
engine's scheduler flags) for every family of the registry.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --preset full --pud-gemv --calib-cache DIR \
        --fleet-subarrays 16 --fleet-cols 65536 [--no-placement] [--engine]
    # gemma-7b needs 1,718,272 placed columns: --fleet-subarrays 32;
    # deepseek-v2-lite-16b 326,016 (MoE: whole-prompt prefill only);
    # zamba2-7b 46,336 with --pud-attention, mamba2-1.3b 50,280,
    # whisper-large-v3 215,706 with --pud-attention, pixtral-12b 1,482,752

The VLM (pixtral) and the encoder-decoder (whisper) draw their stub
frontends' inputs from the seed (patch / frame embeddings, 0.1 x N(0, 1)
in bf16); the VLM's cache spans its patches too, so decode positions start
after them.  As in the reference, ``--engine`` and ``--mesh`` skip those
two families with a message; the hybrid's engine is refused (its cache
has the batch on axis 2), on ``--mesh`` too; the SSM is served on the
mesh, its packed unembed split over the model shards.

The driver decodes the batch once through the bf16 weights, then, with
``--pud-gemv``, opens a ``PUDSession``: calibration (a cached table, or
Algorithm 1 through the ``calib_iter`` kernel plus ECR masks, persisted),
column placement onto error-free columns (unless ``--no-placement``, or
when the model does not fit the grid), ``--weight-bits`` (default 4)
bit-plane packs of the FFN and unembed projections (``--pud-attention``
adds the attention projections), and lockstep greedy decode with every
packed projection in the bit-plane GEMM/GEMV kernels: the placed ones for
placed packs, the unplaced ones otherwise.  ``--tune`` times the kernels'
launch plans for the packs at batch 1 and ``--batch`` on the card, loads
or persists the winners under ``<calib-cache>/tuning`` and decodes on
them; it needs the GPU.  It prints the placement status, token
agreement with the bf16 path, the DDR4-PUD rate models and wall times.
``--engine`` then serves one request per batch row through the
continuous-batching ``ServingEngine`` and prints the share of requests
whose tokens equal the lockstep decode's; ``--chunk-prefill N``,
``--prefix-cache`` and ``--slo-ms X`` turn on its scheduler extensions and
print their counters.

``--monitor`` (with ``--pud-gemv --engine``) reserves canary columns
before packing and serves the requests under the drift monitor
(``runtime/drift.py``); ``--drift-sim`` drifts the simulated device at
step ``--drift-at`` and corrupts the live pack to match, so the loop
detects, recalibrates the drifted subarrays, repacks and hot-swaps while
tokens flow, then checks post-swap decode against a fresh pack.

``--mesh D,M`` (with ``--pud-gemv --engine``) serves through the
tensor- and data-parallel fleet instead: one calibrated logical PUD device
per mesh position (``PUDSession.open_fleet``), every projection's columns
split over the M model shards on placement-window boundaries, one engine
lane per data row (``FleetServingEngine``).  Positions go round the
visible cards, lane d, shard m on card ``(d * M + m) % cards``; with one
card, or ``--device cpu``, all positions share it (the map is printed).

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions instead
(and refuses ``--tune``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.models.params import init_params, param_count
from repro_torch.pud.gemv import ATTN_PACKABLE, FFN_PACKABLE, PUDGemvConfig
from repro_torch.runtime.engine import engine_refusal
from repro_torch.runtime.steps import make_serve_step

#: The seed of the model weights, prompts and device when the caller gives
#: none (the reference's default serve key)
DEFAULT_SEED = 0


@torch.inference_mode()
def greedy_generate(model, params, tokens: torch.Tensor, gen: int,
                    max_len: int, extras: dict | None = None,
                    prefix_len: int = 0):
    """Prefill then ``gen`` greedy steps.

    ``extras``: the stub frontends' embeddings, passed to the prefill after
    the tokens (the VLM's ``{"patches": ...}``, the encoder-decoder's
    ``{"frames": ...}``); ``prefix_len``: positions before the prompt in
    the cache (the VLM's patch prefix), so decode positions start at
    prompt + prefix.  Returns (tokens [B, gen] int32, logits [B, gen + 1,
    V] float32): the logits of the prefill and of every decode step.
    """
    step = make_serve_step(model)
    logits, cache = model.prefill(params, tokens, *(extras or {}).values(),
                                  max_len=max_len)
    cur = tokens.shape[1] + prefix_len
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out, all_logits = [], [logits]
    for i in range(gen):
        out.append(nxt)
        nxt, logits, cache = step(params, cache, nxt, cur + i)
        all_logits.append(logits)
    return torch.cat(out, dim=1), torch.stack(all_logits, dim=1)


def frontend_extras(model, family: str, batch: int, seed: int,
                    device) -> tuple[dict, int]:
    """The stub frontends' inputs drawn from the seed, as the reference's
    serve draws them (0.1 x a standard normal, bf16): (extras, prefix
    length in the cache).  The VLM gets ``patches`` [batch, n_patches,
    d_vit] and a prefix of n_patches; the encoder-decoder ``frames``
    [batch, n_frames, d_model]; the other families nothing."""
    c = model.cfg
    if family == "vlm":
        shape, name, prefix = (batch, c.n_patches, c.d_vit), "patches", \
            c.n_patches
    elif family == "encdec":
        shape, name, prefix = (batch, c.n_frames, c.d_model), "frames", 0
    else:
        return {}, 0
    x = torch.randn(shape, generator=generator(seed, name, device=device),
                    device=device)
    return {name: (0.1 * x).to(torch.bfloat16)}, prefix


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, fn, *args):
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, time.perf_counter() - t0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--preset", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--pud-gemv", action="store_true",
                    help="serve the FFN and unembed projections as "
                         "bit-plane packs")
    ap.add_argument("--engine", action="store_true",
                    help="also serve through the continuous-batching "
                         "ServingEngine (one request per batch row); with "
                         "--pud-gemv it serves the packs, alone the bf16 "
                         "tree")
    ap.add_argument("--chunk-prefill", type=int, default=None, metavar="N",
                    help="chunked prefill: admit prompts N tokens per step "
                         "interleaved with decode waves (pow2-rounded; "
                         "bit-identical to whole-request prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="LRU reuse of completed prefills: repeated "
                         "prompts skip prefill, shared system prompts "
                         "resume after the cached prefix")
    ap.add_argument("--slo-ms", type=float, default=None, metavar="X",
                    help="SLO-aware admission with an X ms default "
                         "deadline per request: earliest-deadline-first "
                         "admission priced by the placement rate model, "
                         "hopeless and expired requests shed")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="engine decode slots; default = the session's "
                         "occupancy-derived optimal batch")
    ap.add_argument("--pud-attention", action="store_true",
                    help="also pack attention wq/wk/wv/wo onto the PUD path")
    ap.add_argument("--tune", action="store_true",
                    help="with --pud-gemv: autotune the kernels' launch "
                         "plans at startup (persisted under "
                         "<calib-cache>/tuning; a hit costs a file read); "
                         "needs the GPU")
    ap.add_argument("--weight-bits", type=int, default=4)
    ap.add_argument("--no-placement", dest="placement",
                    action="store_false", default=True,
                    help="with --calib-cache: skip column placement and "
                         "pack onto logical columns (faulty ones included)")
    ap.add_argument("--monitor", action="store_true",
                    help="with --pud-gemv --engine: reserve canary columns, "
                         "probe them between decode steps (runtime/drift.py) "
                         "and recover from detected drift by a partial "
                         "recalibration and a between-steps hot swap")
    ap.add_argument("--drift-sim", action="store_true",
                    help="with --monitor: drift the simulated device "
                         "(core/reliability.DriftSimulator) mid-serve and "
                         "run the whole detect / recalibrate / swap loop")
    ap.add_argument("--drift-at", type=int, default=3,
                    help="engine step at which --drift-sim drifts")
    ap.add_argument("--drift-temp", type=float, default=3000.0,
                    help="simulated operating temperature in C; the default "
                         "is a stress far beyond the paper's envelope, so "
                         "one probe round detects it")
    ap.add_argument("--drift-days", type=float, default=0.0,
                    help="simulated days since calibration (time-drift leg)")
    ap.add_argument("--drift-subarrays", default="1,5",
                    help="comma-separated subarray ids hit by --drift-sim")
    ap.add_argument("--probe-every", type=int, default=4,
                    help="canary probe cadence in engine steps")
    ap.add_argument("--n-canary", type=int, default=16,
                    help="reserved canary columns per subarray")
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="with --pud-gemv --engine: serve through a "
                         "tensor+data-parallel fleet on a DATAxMODEL mesh "
                         "(PUDSession.open_fleet): one calibrated device per "
                         "mesh position, packs sharded on placement-window "
                         "boundaries, one engine lane per data row; "
                         "positions share cards when there are fewer cards")
    ap.add_argument("--calib-cache", default=None, metavar="DIR",
                    help="persistent calibration-table cache")
    ap.add_argument("--device-id", default="dimm0")
    ap.add_argument("--fleet-subarrays", type=int, default=16,
                    help="subarray grid size used on a cache miss")
    ap.add_argument("--fleet-cols", type=int, default=2048,
                    help="columns per subarray used on a cache miss")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.monitor and not (args.pud_gemv and args.engine):
        ap.error("--monitor requires --pud-gemv and --engine")
    if args.drift_sim and not args.monitor:
        ap.error("--drift-sim requires --monitor")
    if args.mesh and not (args.pud_gemv and args.engine):
        ap.error("--mesh requires --pud-gemv and --engine")
    if args.mesh and args.monitor:
        ap.error("--mesh and --monitor are mutually exclusive (use "
                 "runtime.drift.FleetDriftMonitor programmatically)")
    if args.tune and not args.pud_gemv:
        ap.error("--tune requires --pud-gemv")
    if args.tune and args.device is not None and \
            torch.device(args.device).type != "cuda":
        ap.error(f"--tune times the CUDA kernels' launch plans and needs "
                 f"the GPU; the plain versions on --device {args.device} "
                 "take no plan")
    return args


def run(args: argparse.Namespace) -> dict:
    """Serve one batch as the CLI does; returns what it printed, as data
    (tokens, logits, the session, the engine and timings)."""
    device = resolve_device(args.device)
    spec = get(args.arch)
    model = spec.make_smoke() if args.preset == "smoke" else spec.make_model()
    params, t_init = _timed(device, init_params, model.param_defs(),
                            args.seed, device)
    print(f"[serve] {args.arch} ({args.preset}, "
          f"{param_count(model.param_defs()):,} params) on {device} "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"(init {t_init:.2f}s)")
    vocab = getattr(model.cfg, "lm", model.cfg).vocab
    tokens = torch.randint(0, vocab, (args.batch, args.prompt_len),
                           generator=generator(args.seed + 1, "prompt",
                                               device=device),
                           device=device, dtype=torch.int32)
    max_len = args.prompt_len + args.gen + 1
    extras, prefix_len = frontend_extras(model, spec.family, args.batch,
                                         args.seed + 1, device)
    max_len += prefix_len          # the VLM's cache spans patches + text
    (ref_toks, ref_logits), t_ref = _timed(
        device, greedy_generate, model, params, tokens, args.gen, max_len,
        extras, prefix_len)
    print(f"  bf16 path: {args.batch * args.gen} tokens in {t_ref:.2f}s "
          "wall")
    res = {"model": model, "params": params, "tokens": tokens,
           "max_len": max_len, "frontend": extras, "prefix_len": prefix_len,
           "ref_toks": ref_toks, "ref_logits": ref_logits,
           "wall_s": {"init": t_init, "bf16": t_ref}}
    if args.mesh:
        if extras:
            print("  fleet: vlm/encdec families not supported yet "
                  "(extras require family-specific prefill); skipping")
        elif engine_refusal(model) is not None:
            print(f"  fleet: {engine_refusal(model)}; skipping")
        else:
            _sharded_serve(args, spec, model, params, tokens, max_len,
                           ref_toks, res)
        return res
    session = None
    serve_params, lock_toks = params, ref_toks
    if args.pud_gemv:
        session = _pud_path(args, spec, model, params, tokens, max_len,
                            ref_toks, ref_logits, res)
        serve_params, lock_toks = res["packed"].params, res["toks"]
    if args.engine:
        if extras:
            print("  engine: vlm/encdec families not supported yet "
                  "(extras require family-specific prefill); skipping")
            return res
        refusal = engine_refusal(model)
        if refusal is not None:
            print(f"  engine: {refusal}; skipping")
            return res
        _engine_path(args, spec, model, serve_params, session, tokens,
                     max_len, lock_toks, res)
    return res


def _pud_path(args, spec, model, params, tokens, max_len, ref_toks,
              ref_logits, res):
    """Calibrate, place, pack and decode in lockstep through the packs;
    returns the session and fills ``res``."""
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.runtime.session import PUDSession

    device = tokens.device
    packable = FFN_PACKABLE + (ATTN_PACKABLE if args.pud_attention else ())
    cfg = PUDGemvConfig(weight_bits=args.weight_bits, packable=packable)
    session = PUDSession.open(
        args.arch,
        grid=FleetConfig(n_channels=1, n_banks=1,
                         n_subarrays=args.fleet_subarrays,
                         n_cols=args.fleet_cols),
        cache_dir=args.calib_cache, device_id=args.device_id,
        calib=CalibrationConfig(n_iterations=12, n_samples=256),
        seed=args.seed + 2, placement=args.placement, device=device)
    res["session"] = session
    if args.calib_cache:
        st = session.calibrate()
        status = ("HIT (no recalibration)" if st.cache_hit
                  else "MISS (identified + persisted)")
        print(f"  calibration table [{args.device_id}] {status} "
              f"in {st.wall_s:.2f}s: "
              f"{session.fleet_cfg.n_subarrays_total} subarrays, "
              f"mean ECR {st.mean_ecr:.3f}")
        res["wall_s"]["calibrate"] = st.wall_s
    if args.monitor:
        # canaries are carved out before packing so placement avoids
        # them; a cache-less session calibrates here
        if session.calibration is None:
            st = session.calibrate()
            print(f"  calibration (for --monitor): identified "
                  f"{session.fleet_cfg.n_subarrays_total} subarrays "
                  f"in {st.wall_s:.2f}s")
        session.reserve_canaries(args.n_canary)
        print(f"  canaries: {args.n_canary}/subarray reserved "
              f"(set {session.canaries.fingerprint()}), excluded "
              "from placement")

    packed, t_pack = _timed(
        device, lambda: session.pack(params, cfg,
                                     name=f"{args.arch}-{args.preset}"))
    res["packed"], res["wall_s"]["pack"] = packed, t_pack
    res["placement"] = (session.placement_status, session.placement_name)
    if session.placement_status == "skipped":
        print(f"  placement: SKIPPED ({session.placement_error}); "
              "serving on logical columns")
    elif session.placement is not None:
        rep = session.placement.capacity_report()
        pstatus = ("HIT" if session.placement_status == "hit"
                   else "planned + persisted")
        print(f"  placement [{session.placement_name}] {pstatus}: "
              f"{rep['used_cols']:,}/{rep['usable_cols']:,} "
              "error-free columns used "
              f"(occupancy {rep['occupancy']:.1%}, "
              f"{rep['occupied_subarrays']}/{rep['n_subarrays']} subarrays, "
              f"{len(rep['spilled_tensors'])} tensors spilled); "
              f"pack {t_pack:.2f}s")

    if args.tune:
        # plans load from the tuning cache (a miss searches and persists)
        # and are stamped on the packs: both decode paths below run them
        trep, t_tune = _timed(device, lambda: session.tune(
            batches=sorted({1, args.batch})))
        n_hit = sum(r["status"] == "hit" for r in trep["keys"].values())
        print(f"  autotune: {len(trep['keys'])} keys ({n_hit} cache hits, "
              f"{len(trep['keys']) - n_hit} searched) in {t_tune:.2f}s")
        for tkey, row in sorted(trep["keys"].items()):
            speed = (f"  {row['speedup']:.2f}x vs heuristic"
                     if "speedup" in row else "")
            print(f"    {row['status']:<5s} {tkey}: "
                  f"{row['plan'] or 'heuristic'}{speed}")
        packed = res["packed"] = session.packed
        res["tuning"], res["wall_s"]["tune"] = trep, t_tune

    extras = session.decode_extras()
    (toks, logits), t_pud = _timed(
        device, greedy_generate, model, packed.params, tokens, args.gen,
        max_len, res["frontend"], res["prefix_len"])
    agree = float((toks == ref_toks).float().mean())
    delta = float((logits - ref_logits).abs().max())
    print(f"  pud-gemv path ({cfg.weight_bits}-bit planes, "
          f"{extras['n_packed']} projections packed, "
          f"{extras['layout']} columns, "
          f"{extras['stored_bytes'] / 2**20:.1f} MiB bit-packed "
          f"vs {extras['dense_equiv_bytes'] / 2**20:.1f} MiB dense): "
          f"{args.batch * args.gen} tokens in {t_pud:.2f}s wall")
    print(f"    token agreement vs bf16: {100 * agree:.1f}%   "
          f"max |logit delta|: {delta:.3f} "
          "(quantization, not error: the kernels are exact int math)")
    res.update(toks=toks, logits=logits, agreement=agree, extras=extras,
               max_logit_delta=delta)
    res["wall_s"]["pud"] = t_pud

    # DRAM-side throughput model: what the paper's system sustains.
    perf = session.perf_report(2 * spec.n_active_params)
    print(f"    DDR4-PUD serving model ({args.arch} full config, "
          f"{cfg.weight_bits}-bit): "
          f"baseline {perf['baseline_tok_s']:.2f} tok/s"
          f" -> PUDTune {perf['tuned_tok_s']:.2f}"
          f" tok/s ({perf['gain']:.2f}x, Eq. 1)")
    if session.placement is not None:
        print("    placement-derived rate (occupied-subarray waves): "
              f"{perf['placed_tok_s']:.2f} "
              f"tok/s at {session.placement.occupancy:.1%} occupancy")
    return session


def _sharded_serve(args, spec, model, params, tokens, max_len, ref_toks,
                   res) -> None:
    """Serve through the tensor- and data-parallel fleet (``--mesh D,M``);
    fills ``res``.

    Opens one logical ``PUDSession`` per mesh position, calibrates them,
    packs each lane's model shards (no placement window straddles a
    shard) and drains the requests through one ``ServingEngine`` lane per
    data row; per-request decode stays bit-identical to the single-device
    engine's, and tokens are held against the bf16 path as on the
    unsharded path.
    """
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.launch.mesh import parse_mesh_spec
    from repro_torch.runtime.engine import Request
    from repro_torch.runtime.session import PUDSession

    device = tokens.device
    mesh = parse_mesh_spec(args.mesh, device=device)
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    packable = FFN_PACKABLE + (ATTN_PACKABLE if args.pud_attention else ())
    cfg = PUDGemvConfig(weight_bits=args.weight_bits, packable=packable)
    fleet = PUDSession.open_fleet(
        args.arch, mesh=mesh,
        grid=FleetConfig(n_channels=1, n_banks=1,
                         n_subarrays=args.fleet_subarrays,
                         n_cols=args.fleet_cols),
        cache_dir=args.calib_cache, device_id=args.device_id,
        calib=CalibrationConfig(n_iterations=12, n_samples=256),
        seed=args.seed + 2, placement=args.placement)
    res["fleet"] = fleet
    print(f"[serve] fleet mesh {n_data}x{n_model} (data x model), "
          f"{fleet.n_devices} logical devices: {mesh.describe()}")
    states, t_cal = _timed(device, fleet.calibrate)
    hits = sum(st.cache_hit for row in states for st in row)
    print(f"  calibration: {fleet.n_devices} devices in {t_cal:.2f}s "
          f"({hits} cache hits)")
    packs, t_pack = _timed(device, lambda: fleet.pack(
        params, cfg, name=f"{args.arch}-{args.preset}-fleet"))
    statuses = [[s.placement_status or "logical" for s in row]
                for row in fleet.sessions]
    print(f"  placement per shard: {statuses}; "
          f"shard widths {list(fleet.shard_widths)} "
          f"(windows never straddle a shard); pack {t_pack:.2f}s")
    res["wall_s"].update(calibrate=t_cal, pack=t_pack)
    if args.tune:
        trep, t_tune = _timed(device, lambda: fleet.tune(
            batches=sorted({1, args.batch})))
        n_hit = sum(r["status"] == "hit" for r in trep["keys"].values())
        print(f"  autotune: {len(trep['keys'])} per-shard keys "
              f"({n_hit} cache hits, {len(trep['keys']) - n_hit} searched) "
              f"in {t_tune:.2f}s")
        res["tuning"], res["wall_s"]["tune"] = trep, t_tune

    engine = fleet.serving_engine(model, max_len=max_len,
                                  batch_size=args.batch_size,
                                  **_scheduler_kwargs(args))
    requests = [Request(request_id=i, tokens=tokens[i],
                        max_new_tokens=args.gen)
                for i in range(args.batch)]
    completions, t_eng = _timed(device, engine.run, requests)
    sched = engine.scheduler_report()
    print(f"  fleet engine: {sched['completed']} requests over "
          f"{sched['n_lanes']} lanes in {sched['steps']} steps "
          f"({sched['batch_size']} slots/lane, "
          f"{sched['generated_tokens']} tokens; {t_eng:.2f}s wall)")
    _print_scheduler_extras(sched)
    agree = sum(c.tokens == ref_toks[c.request_id].tolist()
                for c in completions) / len(completions)
    print(f"    token agreement vs bf16: {100 * agree:.1f}% "
          "(quantization only — sharded decode is bit-identical to the "
          "single-device engine)")
    perf = engine.perf_report(2 * spec.n_active_params)
    print(f"    aggregate DDR4-PUD model: {perf['aggregate_tok_s']:.2f} "
          f"tok/s over {perf['n_devices']} devices, scaling efficiency "
          f"{perf['scaling_efficiency']:.2f} "
          f"(slowest-shard work share {perf['shard_fraction']:.3f})")
    res.update(packs=packs, engine=engine, completions=completions,
               sched=sched, agreement=agree, perf=perf)
    res["wall_s"]["engine"] = t_eng


def _scheduler_kwargs(args) -> dict:
    """The engine's scheduler extensions from the CLI flags (all off by
    default)."""
    return {
        "chunk_prefill": args.chunk_prefill,
        "prefix_cache": bool(args.prefix_cache),
        "slo": args.slo_ms,
    }


def _print_scheduler_extras(sched: dict, indent: str = "    ") -> None:
    """Prefix-cache and SLO counter lines (only when the features are on)."""
    pc = sched.get("prefix_cache")
    if pc:
        print(f"{indent}prefix cache: {pc['hits']} hits / "
              f"{pc['misses']} misses ({pc['hit_rate']:.0%}), "
              f"{pc['entries']} entries ({pc['bytes'] / 1024:.0f} KiB), "
              f"{pc['invalidations']} invalidations")
    slo = sched.get("slo")
    if slo:
        print(f"{indent}slo: {slo['met']} met / {slo['missed']} missed "
              f"(shed {slo['shed_on_admit']} at admission, "
              f"{slo['shed_admitted']} in flight; "
              f"modeled step {slo['step_ms']:.3f} ms)")


def _engine_path(args, spec, model, serve_params, session, tokens, max_len,
                 lock_toks, res):
    """Serve one request per batch row through the ServingEngine and hold
    its tokens against the lockstep decode's; fills ``res``."""
    from repro_torch.runtime.engine import Request, ServingEngine

    engine = ServingEngine(model, serve_params, session=session,
                           max_len=max_len, batch_size=args.batch_size,
                           **_scheduler_kwargs(args))
    requests = [Request(request_id=i, tokens=tokens[i],
                        max_new_tokens=args.gen)
                for i in range(args.batch)]
    if args.monitor:
        _, t_mon = _timed(tokens.device, _monitored_serve, args, session,
                          engine, model, res["params"], requests, tokens,
                          max_len, res)
        res["wall_s"]["monitor"] = t_mon
        return
    completions, t_eng = _timed(tokens.device, engine.run, requests)
    sched = engine.scheduler_report()
    print(f"  engine: {sched['completed']} requests, "
          f"{sched['generated_tokens']} tokens in {sched['steps']} steps "
          f"({sched['batch_size']} slots, "
          f"occupancy {sched['slot_occupancy']:.1%}, "
          f"{sched['wall_tok_s']:.1f} tok/s decode wall, "
          f"{sched['prefill_traces']} prefill buckets; {t_eng:.2f}s wall)")
    if args.chunk_prefill:
        print(f"    chunked prefill: {sched['prefill_chunks']} chunks "
              f"of {engine.chunk_prefill} tokens "
              f"({sched['chunk_traces']} chunk shapes)")
    _print_scheduler_extras(sched)
    # continuous batching must not change any request's tokens
    same = [c.tokens == lock_toks[i].tolist()
            for i, c in enumerate(completions)]
    agree = sum(same) / len(same)
    print("    batched vs lockstep decode: "
          f"{100 * agree:.1f}% of requests bit-identical")
    res.update(engine=engine, completions=completions, sched=sched,
               engine_agreement=agree)
    res["wall_s"]["engine"] = t_eng
    if session is not None:
        perf = session.perf_report(2 * spec.n_active_params,
                                   batch_size=engine.batch_size)
        if "batched_tok_s" in perf:
            print("    DDR4-PUD batched rate: "
                  f"{perf['batched_tok_s']:.2f} aggregate tok/s at "
                  f"batch {perf['batch_size']} "
                  f"({perf['batch_speedup']:.2f}x over batch-1; "
                  f"occupancy-derived optimum {perf['optimal_batch']})")


def _monitored_serve(args, session, engine, model, params, requests,
                     tokens, max_len, res) -> None:
    """Serve ``requests`` under the drift monitor (--monitor); fills
    ``res["monitor"]``.

    With ``--drift-sim`` the simulator drifts the device's sense offsets at
    step ``--drift-at`` and the live pack is corrupted to match (faults
    re-derived from the drifted offsets, injected into the serving tree), so
    the canary probes detect a real numeric failure.  The controller then
    drives detection -> partial recalibration -> repack -> hot swap between
    steps, and a spot check holds post-swap decode equal to a fresh decode
    on the recovered pack (raises otherwise).
    """
    from repro_torch.core.reliability import DriftSimulator
    from repro_torch.runtime.drift import (DriftConfig, DriftController,
                                           DriftMonitor, run_with_drift,
                                           sim_read_faults)
    from repro_torch.runtime.engine import Request

    sim = DriftSimulator.for_session(session)
    mon = DriftMonitor(session, sim, config=DriftConfig(
        n_canary=args.n_canary, probe_every=args.probe_every))
    ecr_before = session.calibration.ecr.cpu().numpy().copy()
    ctl = DriftController(
        engine, mon, params, pack_name=f"{args.arch}-{args.preset}",
        read_faults=sim_read_faults(session, sim) if args.drift_sim else None)
    overhead = mon.probe_overhead()
    print(f"  monitor: probing {args.n_canary} canaries/subarray every "
          f"{args.probe_every} steps (amortized overhead "
          + (f"{overhead:.2%}" if overhead is not None else "n/a")
          + " of decode)")

    subs = [int(s) for s in args.drift_subarrays.split(",") if s]
    drift_step = run_with_drift(
        ctl, requests, sim, at=args.drift_at if args.drift_sim else None,
        temp_c=args.drift_temp, days=args.drift_days, subarrays=subs,
        seed=args.seed, n_trials=128, max_ticks=64 * (len(requests) + 8))
    if drift_step is not None:
        print(f"  drift-sim: offsets drifted at step {args.drift_at} "
              f"(temp {args.drift_temp:.0f}C, {args.drift_days:g} "
              f"days, subarrays {subs}); live pack corrupted")

    rep = ctl.report()
    for ev in mon.detector.events:
        print(f"    drift event: subarray {ev.subarray} {ev.severity} "
              f"(canary ECR {ev.new_ecr:.3f}, probe round "
              f"{ev.probe_round})")
    for rec in rep["recoveries"]:
        ecr = ", ".join(f"{g}: {e:.3f}"
                        for g, e in rec["recalibrated_ecr"].items())
        print(f"    recovery: detected step {rec['detected_step']}, "
              f"recalibrated subarrays {rec['subarrays']} "
              f"(post-recal table ECR {{{ecr}}}), hot swap staged at "
              f"step {rec['swap_staged_step']}; recalibrate "
              f"{rec['recalibrate_wall_s'] * 1e3:.1f} ms, repack "
              f"{rec['repack_wall_s'] * 1e3:.1f} ms")
    print(f"    swaps at steps {rep['swap_steps']}, tokens on swap steps "
          f"{rep['swap_step_tokens']}, min tokens/step "
          f"{rep['min_tokens_per_step']} (zero-downtime: no stalled step)")
    sched = engine.scheduler_report()
    print(f"  engine: {sched['completed']} requests, "
          f"{sched['generated_tokens']} tokens in {sched['steps']} steps "
          f"({sched['batch_size']} slots, "
          f"occupancy {sched['slot_occupancy']:.1%})")

    n_ok, post = None, []
    if rep["recoveries"]:
        # post-swap decode must equal a fresh decode on the recovered pack
        post = [Request(request_id=1000 + i, tokens=tokens[i],
                        max_new_tokens=args.gen)
                for i in range(min(2, len(requests)))]
        comps = {c.request_id: c for c in ctl.run(post)}
        fresh = session.packed.params
        n_ok = 0
        for r in post:
            want, _ = greedy_generate(model, fresh, r.tokens[None, :],
                                      args.gen, max_len)
            n_ok += comps[r.request_id].tokens == want[0].tolist()
        print(f"    post-swap spot check: {n_ok}/{len(post)} requests "
              "bit-identical to fresh decode on the recovered pack")
        if n_ok != len(post):
            raise RuntimeError("post-swap decode diverged from fresh pack")
    age = session.calibration_age()
    if age is not None:
        print(f"    table age: {age['age_days']:.4f} days "
              f"(assumed temp {age['assumed_temp_c']:.0f}C)")
    res["monitor"] = dict(report=rep, sim=sim, monitor=mon, controller=ctl,
                          drift_step=drift_step, ecr_before=ecr_before,
                          ecr_after=session.calibration.ecr.cpu().numpy(),
                          spot_ok=n_ok, spot_n=len(post),
                          completions=sorted(engine._completions,
                                             key=lambda c: c.request_id))


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
