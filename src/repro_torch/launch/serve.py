"""Batched serving driver: prefill + greedy decode, optional PUD GEMM path
and continuous-batching engine (port of ``repro/launch/serve.py``: the
``--pud-gemv --calib-cache [--no-placement] [--engine]`` paths).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --preset full --pud-gemv --calib-cache DIR \
        --fleet-subarrays 16 --fleet-cols 65536 [--no-placement] [--engine]

The driver decodes the batch once through the bf16 weights, then, with
``--pud-gemv``, opens a ``PUDSession``: calibration (a cached table, or
Algorithm 1 through the ``calib_iter`` kernel plus ECR masks, persisted),
column placement onto error-free columns (unless ``--no-placement``, or
when the model does not fit the grid), 4-bit bit-plane packs of the FFN and
unembed projections, and lockstep greedy decode with every packed
projection in the bit-plane GEMM/GEMV kernels: the placed ones for placed
packs, the unplaced ones otherwise.  It prints the placement status, token
agreement with the bf16 path, the DDR4-PUD rate models and wall times.
``--engine`` then serves one request per batch row through the
continuous-batching ``ServingEngine`` and prints the share of requests
whose tokens equal the lockstep decode's.

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions instead.
The drift monitor, mesh and tuning paths, the engine's chunked prefill,
prefix cache and SLO admission, attention packing and other weight widths
are not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.models.params import init_params, param_count
from repro_torch.pud.gemv import FFN_PACKABLE, PUDGemvConfig
from repro_torch.runtime.steps import make_serve_step


@torch.inference_mode()
def greedy_generate(model, params, tokens: torch.Tensor, gen: int,
                    max_len: int):
    """Prefill then ``gen`` greedy steps.

    Returns (tokens [B, gen] int32, logits [B, gen + 1, V] float32): the
    logits of the prefill and of every decode step.
    """
    step = make_serve_step(model)
    logits, cache = model.prefill(params, tokens, max_len=max_len)
    cur = tokens.shape[1]
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out, all_logits = [], [logits]
    for i in range(gen):
        out.append(nxt)
        nxt, logits, cache = step(params, cache, nxt, cur + i)
        all_logits.append(logits)
    return torch.cat(out, dim=1), torch.stack(all_logits, dim=1)


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
                    help="serve the FFN and unembed projections as 4-bit "
                         "bit-plane packs")
    ap.add_argument("--engine", action="store_true",
                    help="also serve through the continuous-batching "
                         "ServingEngine (one request per batch row); with "
                         "--pud-gemv it serves the packs, alone the bf16 "
                         "tree")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="engine decode slots; default = the session's "
                         "occupancy-derived optimal batch")
    ap.add_argument("--no-placement", dest="placement",
                    action="store_false", default=True,
                    help="with --calib-cache: skip column placement and "
                         "pack onto logical columns (faulty ones included)")
    ap.add_argument("--calib-cache", default=None, metavar="DIR",
                    help="persistent calibration-table cache")
    ap.add_argument("--device-id", default="dimm0")
    ap.add_argument("--fleet-subarrays", type=int, default=16,
                    help="subarray grid size used on a cache miss")
    ap.add_argument("--fleet-cols", type=int, default=2048,
                    help="columns per subarray used on a cache miss")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch versions)")
    return ap.parse_args(argv)


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
    tokens = torch.randint(0, model.cfg.vocab, (args.batch, args.prompt_len),
                           generator=generator(args.seed + 1, "prompt",
                                               device=device),
                           device=device, dtype=torch.int32)
    max_len = args.prompt_len + args.gen + 1
    (ref_toks, ref_logits), t_ref = _timed(
        device, greedy_generate, model, params, tokens, args.gen, max_len)
    print(f"  bf16 path: {args.batch * args.gen} tokens in {t_ref:.2f}s "
          "wall")
    res = {"model": model, "params": params, "tokens": tokens,
           "max_len": max_len, "ref_toks": ref_toks,
           "ref_logits": ref_logits, "wall_s": {"init": t_init,
                                                "bf16": t_ref}}
    session = None
    serve_params, lock_toks = params, ref_toks
    if args.pud_gemv:
        session = _pud_path(args, spec, model, params, tokens, max_len,
                            ref_toks, ref_logits, res)
        serve_params, lock_toks = res["packed"].params, res["toks"]
    if args.engine:
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
    cfg = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE)
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

    packed, t_pack = _timed(
        device, lambda: session.pack(params, cfg,
                                     name=f"{args.arch}-{args.preset}"))
    res["packed"], res["wall_s"]["pack"] = packed, t_pack
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

    extras = session.decode_extras()
    (toks, logits), t_pud = _timed(
        device, greedy_generate, model, packed.params, tokens, args.gen,
        max_len)
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


def _engine_path(args, spec, model, serve_params, session, tokens, max_len,
                 lock_toks, res):
    """Serve one request per batch row through the ServingEngine and hold
    its tokens against the lockstep decode's; fills ``res``."""
    from repro_torch.runtime.engine import Request, ServingEngine

    engine = ServingEngine(model, serve_params, session=session,
                           max_len=max_len, batch_size=args.batch_size)
    requests = [Request(request_id=i, tokens=tokens[i],
                        max_new_tokens=args.gen)
                for i in range(args.batch)]
    completions, t_eng = _timed(tokens.device, engine.run, requests)
    sched = engine.scheduler_report()
    print(f"  engine: {sched['completed']} requests, "
          f"{sched['generated_tokens']} tokens in {sched['steps']} steps "
          f"({sched['batch_size']} slots, "
          f"occupancy {sched['slot_occupancy']:.1%}, "
          f"{sched['wall_tok_s']:.1f} tok/s decode wall, "
          f"{sched['prefill_traces']} prefill buckets; {t_eng:.2f}s wall)")
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


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
