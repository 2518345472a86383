"""End-to-end training driver on a mesh of positions (port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --preset smoke --steps 60 --save-every 20 --ckpt-dir /tmp/run1 \\
        --device cpu
    # kill it mid-run, then the same command with --resume

Wires the runtime together: the data stream (deterministic, resumable)
-> the microbatched train step (float32 gradient sums, AdamW, optional
int8 error-feedback compression) -> atomic async checkpoints (keep-k,
LATEST) -> resume of the parameters, the optimizer state and the stream
-> the step watchdog and heartbeat file.  Runs on the GPU unless
``--device`` names another device.

The mesh is ``launch/mesh.make_mesh_for_devices()`` over the visible cards
unless ``--mesh D,M`` (positions on ``--device``'s cards, the port's own
flag) or ``run(..., mesh=)`` gives one; the logical->mesh rules go in with
the mesh sizes (``sharding_ctx.set_rules``) for the run.  On a mesh of
more than one position the parameters and AdamW moments are stored as
per-position shards (``runtime/sharding.py``), initialised whole and cut,
resumed straight into shards, and trained by the data-parallel step of
``runtime/steps.py``; a mesh of one position keeps plain tensors and the
one-device step.  Every family but the hybrid splits each lane's compute
over its "model" positions too (``steps.lane_group``).

``--preset smoke`` trains the arch's reduced config, ``paper100m`` a
~100M-parameter qwen3-family model, ``full`` the full config.  The exit
code is 0 when the mean of the last k losses is below the first k's.
``run(args)`` returns the losses and the final state as well (for
``chip_smoke.py``), and ``run(args, stop_at=N)`` ends the run before step N
as a preemption would: the checkpoints written so far stay, no final save
is made.  The schedule depends on ``--steps`` (warmup ``steps // 3 + 1``),
so an interrupted 6-step run resumed with ``--steps 6 --resume`` is the
uninterrupted 6-step run; a 3-step run is another run.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import pathlib
import tempfile
import time

import torch

from repro_torch.configs import get
from repro_torch.core.rng import generator
from repro_torch.devices import resolve_device
from repro_torch.launch.mesh import (make_host_mesh, make_mesh_for_devices,
                                     use_mesh)
from repro_torch.models import sharding_ctx
from repro_torch.models.params import abstract_params, init_params, \
    param_count, param_pspecs
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import DataConfig, DataPipeline
from repro_torch.runtime.optim import OptConfig, init_opt_state, \
    opt_state_pspecs
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.watchdog import Heartbeat, StepWatchdog


def build_model(arch: str, preset: str):
    spec = get(arch)
    if preset == "full":
        return spec.make_model()
    if preset == "smoke":
        return spec.make_smoke()
    if preset == "paper100m":
        from repro_torch.models.transformer import LMConfig, TransformerLM
        return TransformerLM(LMConfig(      # ~105M params
            name=f"{arch}-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=6, d_ff=3072, vocab=16384, head_dim=64,
            loss_chunk=128))
    raise ValueError(preset)


def family_extras(spec, model, batch_shape, step: int, seed: int = 0) -> dict:
    """The stub frontends' inputs (patch or frame embeddings), 0.1 x N(0, 1)
    in bf16 from a generator tagged ``(seed, 0xF00D, step)``, so they never
    share a stream with the init or data streams of the same seed.  CPU
    tensors, as the data stream's."""
    b = batch_shape[0]
    gen = generator(seed, 0xF00D, step)
    c = model.cfg
    if spec.family == "vlm" and hasattr(c, "n_patches"):
        shape, name = (b, c.n_patches, c.d_vit), "patches"
    elif spec.family == "encdec" and hasattr(c, "n_frames"):
        shape, name = (b, c.n_frames, c.d_model), "frames"
    else:
        return {}
    return {name: 0.1 * torch.randn(shape, generator=gen).to(torch.bfloat16)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--preset", default="smoke",
                    choices=("smoke", "paper100m", "full"))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs there)")
    ap.add_argument("--mesh", default=None,
                    help="D,M: a (data D, model M) mesh of positions on the "
                         "device's cards (default: one per visible card)")
    return ap.parse_args(argv)


def batch_digest(batch: dict) -> str:
    """SHA-256 over a batch's leaves (name order, raw bytes): equal digests
    are equal batches, bit for bit."""
    h = hashlib.sha256()
    for name in sorted(batch):
        h.update(name.encode())
        h.update(batch[name].contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def run(args: argparse.Namespace, step_context=None, on_restore=None,
        stop_at: int | None = None, mesh=None) -> dict:
    """Train as ``main`` does.  ``step_context(step)``, if given, is a
    context manager entered around each step (the caller's profiler);
    ``on_restore(tree)`` sees the restored ``{"params", "opt"}`` before the
    first step of a resumed run; ``stop_at`` ends the run before that step
    (in-flight saves finish, no final save); ``mesh`` replaces the default
    mesh.  Returns {"rc", "losses", "grad_norms", "lrs", "step_s",
    "digests" (per step, ``batch_digest``), "start_step", "params",
    "opt_state", "n_params", "tokens_per_step", "mesh",
    "bytes_per_position" (parameter and optimizer-state bytes per mesh
    position, sharded runs), "ckpt": {"saves": [{"step", "async",
    "snapshot_s"}], "writes": CheckpointManager.writes, "restore_s"}}."""
    dev = resolve_device(args.device)
    if mesh is None and getattr(args, "mesh", None):
        mesh = make_host_mesh(*(int(v) for v in args.mesh.split(",")),
                              device=dev)
    mesh = mesh or make_mesh_for_devices(dev)
    before = sharding_ctx.get_rules()
    try:
        with use_mesh(mesh):
            rules = shd.make_rules(mesh)
            sharding_ctx.set_rules({**rules, "_mesh_sizes": mesh.shape})
            return _run(args, dev, mesh, rules, step_context, on_restore,
                        stop_at)
    finally:
        sharding_ctx.set_rules(before)


def _run(args, dev, mesh, rules, step_context, on_restore, stop_at) -> dict:
    spec = get(args.arch)
    model = build_model(args.arch, args.preset)
    lm_cfg = getattr(model.cfg, "lm", None) or model.cfg
    seq = args.seq_len or (128 if args.preset != "full" else 4096)
    gbs = args.global_batch or (8 if args.preset != "full" else 256)
    opt_cfg = OptConfig(total_steps=max(args.steps, 200),
                        warmup_steps=min(20, args.steps // 3 + 1),
                        compress_grads=args.compress_grads)
    data_cfg = DataConfig(vocab=lm_cfg.vocab, seq_len=seq, global_batch=gbs,
                          seed=args.seed)
    pipe = DataPipeline(data_cfg)
    defs = model.param_defs()
    sharded = mesh.size > 1
    if sharded:
        pspecs = param_pspecs(defs, rules)
        cuts = {"params": shd.named(mesh, pspecs),
                "opt": shd.named(mesh, opt_state_pspecs(pspecs, opt_cfg))}

    ckpt = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    ck = {"saves": [], "writes": [], "restore_s": None}
    start_step = 0
    params = opt_state = None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        tmpl_params = abstract_params(defs)
        tmpl = {"params": tmpl_params,
                "opt": init_opt_state(tmpl_params, opt_cfg)}
        t0 = time.perf_counter()
        tree, step, meta = ckpt.restore(
            tmpl, device=dev, shardings=cuts if sharded else None)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ck["restore_s"] = time.perf_counter() - t0
        params, opt_state = tree["params"], tree["opt"]
        pipe = DataPipeline.from_state(data_cfg, meta["data"])
        start_step = step
        print(f"[train] resumed from step {step} "
              f"(data stream continues at {pipe.next_step})")
        if on_restore is not None:
            on_restore(tree)
        del tree
    if params is None:
        params = init_params(defs, args.seed, dev)
        if sharded:
            params = shd.device_put(params, cuts["params"])
        opt_state = init_opt_state(params, opt_cfg)

    n_params = param_count(defs)
    where = (f"mesh {mesh.shape} ({mesh.describe()})" if sharded
             else f"1 ({dev})")
    print(f"[train] arch={args.arch} preset={args.preset} params={n_params:,}"
          f" devices={where} seq={seq} batch={gbs}")
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              batch_axes=shd.batch_axes(mesh))

    def on_hang(waited):
        raise TimeoutError(f"step hung for {waited:.0f}s")

    dog = StepWatchdog(on_hang=on_hang)
    hb = Heartbeat(args.ckpt_dir or pathlib.Path(tempfile.gettempdir())
                   / "repro_torch_hb", host_id=0)
    out = {"losses": [], "grad_norms": [], "lrs": [], "step_s": [],
           "digests": []}
    saved_at = None

    def save(step, sync: bool, **meta):
        nonlocal saved_at
        tree = {"params": params, "opt": opt_state}
        meta = {"data": pipe.state(), **meta, "arch": args.arch}
        t0 = time.perf_counter()
        if sync:
            ckpt.save(step, tree, metadata=meta)
        else:
            ckpt.save_async(step, tree, metadata=meta)
        ck["saves"].append({"step": step, "async": not sync,
                            "snapshot_s": time.perf_counter() - t0})
        saved_at = step

    end = args.steps if stop_at is None else min(stop_at, args.steps)
    for step in range(start_step, end):
        batch = next(pipe)
        batch.update(family_extras(spec, model, batch["tokens"].shape, step,
                                   seed=args.seed))
        out["digests"].append(batch_digest(batch))
        if not sharded:         # the lanes take their rows themselves
            batch = {k: v.to(dev) for k, v in batch.items()}
        ctx = step_context(step) if step_context else contextlib.nullcontext()
        with ctx:
            dog.start_step(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])
            stats = dog.end_step()
        hb.beat(step, loss=loss)
        out["losses"].append(loss)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["lrs"].append(float(metrics["lr"]))
        out["step_s"].append(stats["step_time_s"])
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"  step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({stats['step_time_s']:.2f}s"
                  f"{' STRAGGLER' if stats['straggler'] else ''})",
                  flush=True)
        if ckpt and (step + 1) % args.save_every == 0:
            save(step + 1, False, loss=loss)
    if ckpt:
        ckpt.wait()
        if end == args.steps and saved_at != args.steps:
            save(args.steps, True)   # (else the last state is on disk)
        ck["writes"] = ckpt.writes
    dog.close()

    losses = out["losses"]
    k = min(10, max(1, len(losses) // 4))
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'}), "
          f"stragglers={len(dog.stragglers)}")
    held = (shd.bytes_per_position({"params": params, "opt": opt_state})
            if sharded else None)
    return {**out, "rc": 0 if last < first else 1, "start_step": start_step,
            "params": params, "opt_state": opt_state, "n_params": n_params,
            "tokens_per_step": gbs * seq, "ckpt": ck, "mesh": mesh,
            "bytes_per_position": held}


def main(argv=None) -> int:
    return run(parse_args(argv))["rc"]


if __name__ == "__main__":
    raise SystemExit(main())
