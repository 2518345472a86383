"""Batched serving driver: prefill + greedy decode, optional PUD GEMM path
(port of ``repro/launch/serve.py``: the ``--pud-gemv --calib-cache`` path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --preset full --pud-gemv --calib-cache DIR \
        --fleet-subarrays 16 --fleet-cols 65536

The driver decodes the batch once through the bf16 weights, then, with
``--pud-gemv``, opens a ``PUDSession``: calibration (a cached table, or
Algorithm 1 through the ``calib_iter`` kernel plus ECR masks, persisted),
column placement onto error-free columns, placed bit-plane packs of the FFN
and unembed projections, and greedy decode with every packed projection
going through the placed GEMM/GEMV kernels.  It prints the placement
status, token agreement with the bf16 path and wall times.

Runs on the GPU; ``--device cpu`` runs the plain PyTorch versions instead.
The engine, drift monitor, mesh and tuning paths, attention packing, other
weight widths and unplaced serving are not ported yet.
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
                         "placed bit-plane packs")
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
    (tokens, logits, the session and timings)."""
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.runtime.session import PUDSession

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
    if not args.pud_gemv:
        return res

    cfg = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE)
    session = PUDSession.open(
        args.arch,
        grid=FleetConfig(n_channels=1, n_banks=1,
                         n_subarrays=args.fleet_subarrays,
                         n_cols=args.fleet_cols),
        cache_dir=args.calib_cache, device_id=args.device_id,
        calib=CalibrationConfig(n_iterations=12, n_samples=256),
        seed=args.seed + 2, device=device)
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
    return res


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
