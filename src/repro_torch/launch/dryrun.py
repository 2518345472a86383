"""Dry run of every (architecture x input shape) cell on the reference's
production meshes (port of ``repro/launch/dryrun.py``), on meta tensors:
no card is touched and nothing is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi] [--variant V] [--force]
        [--save-hlo]

The mesh is ``make_production_mesh(multi_pod=..., device="meta")``: (data
16, model 16) or (pod 2, data 16, model 16).  The port runs the same
program on every data lane (``runtime/steps.py``: the lanes gather the
parameters, each runs its rows), so a cell traces one position of the
first lane, the first and fullest, under
``launch/cost_analysis.CostMode``.  For every family but the hybrid the
lane's "model" positions split its compute (``steps.lane_group``), and the
trace is that position's program alone: its own blocks of the leaves on
"model", its share of every split product, the replicated work, and the
collectives with the other positions (``scheme``: ``SCHEME_SPLIT``).  The
hybrid (zamba2-7b) computes the lane whole on its first position
(``SCHEME``):

  * train: ``steps.gather_lane_params``, then one microbatch of the lane
    (``steps.lanes_grads``) and the position's part of the float32
    reduce-scatter (``steps.reduce_grads_at``), counted ``microbatch``
    times (the eager loop's iterations; the reference multiplies its scan
    bodies by their trip counts instead), then ``optim.adamw_update`` on
    the position's shards;
  * prefill / decode: ``steps.make_lane_prefill_step`` /
    ``make_lane_decode_step`` on the lane's rows: the gather, then the
    model's step (decode: the position's cache blocks gathered from their
    shards first).

Resident bytes of the position (live before the trace): its parameter
shards, in train cells its float32 moments and gradient accumulators, in
decode cells its cache shards.  Where the reference replicates the batch
(the global batch does not split over the batch axes: long_500k at batch
1) every position runs the whole batch: one lane over all rows.

Each record goes to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__
<variant>].json`` with the reference's keys where they mean something
here (``flops_per_device``, ``bytes_per_device``, ``collectives``,
``peak_bytes_per_device``; ``lower_s`` is ``trace_s``) and ``"scheme"``.
``--save-hlo`` writes the per-op counts (``<tag>.ops.txt``) in place of
HLO text.  The reference's ``xla_flops_scan_once``, ``collective_bytes``
(of HLO text) and ``memory_analysis`` read XLA's compiled module and have
no counterpart.  Restartable: cells with a record are skipped unless
``--force``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time

import torch

from repro_torch.configs import SHAPES, ShapeCell, all_archs, get
from repro_torch.launch.cost_analysis import CostMode, summarize
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import sharding_ctx
from repro_torch.models.params import param_pspecs, tree_leaves, tree_map
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps
from repro_torch.runtime.optim import OptConfig, adamw_update, init_opt_state

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
SCHEME = "data lanes; the model axis shards storage only"
SCHEME_SPLIT = "data lanes; the model axis splits compute"


def scheme(model) -> str:
    """The record's ``scheme``: the split for the families whose model
    splits the "model" axis's compute (``runtime/steps.lane_group``)."""
    return SCHEME_SPLIT if getattr(model, "model_split", False) else SCHEME


def sharding_overrides(spec, mesh, kind: str, model=None) -> dict:
    """Per-arch logical-axis overrides for divisibility on this mesh (the
    reference's policy): q heads, kv heads and the vocab replicate where
    the "model" axis does not divide them; decode and prefill caches
    sequence-shard over "model" when their kv heads cannot (and for
    MLA).  ``model``: the one to size them for (default the arch's
    full-size model)."""
    msize = mesh.shape["model"]
    cfg = getattr(model or spec.make_model(), "cfg", None)
    lm = getattr(cfg, "lm", None) or cfg
    ov = {}

    def dims(name, default=0):
        return getattr(lm, name, default)

    n_heads, n_kv, vocab = dims("n_heads"), dims("n_kv_heads"), dims("vocab")
    is_mla = dims("attention", "gqa") == "mla"
    if n_heads and n_heads % msize:
        ov["heads"] = None
    kv_sharded = bool(n_kv) and n_kv % msize == 0
    if n_kv and not kv_sharded:
        ov["kv_heads"] = None
    if vocab and vocab % msize:
        ov["vocab"] = None
    if kind in ("decode", "prefill") and (is_mla or not kv_sharded):
        ov["kv_seq"] = "model"
    return ov


def pick_microbatch(requested: int, global_batch: int, mesh) -> int:
    """The largest count up to ``requested`` that splits the batch into
    microbatches whose rows split evenly over the batch shards."""
    shards = mesh.shape["data"] * mesh.shape.get("pod", 1)
    k = max(1, requested)
    while k > 1 and (global_batch % k or (global_batch // k) % shards):
        k -= 1
    return k


def _zeros(defs, specs, mesh):
    """Meta zeros of a ParamDef tree, sharded by ``specs`` on ``mesh``."""
    return tree_map(lambda d, s: shd.zeros(d.shape, d.dtype,
                                           shd.NamedSharding(mesh, s)),
                    defs, specs)


def _at(tree, c):
    """Every ``ShardedTensor`` of ``tree`` cut down to position ``c``'s
    shard (a position's own part of a per-position loop)."""
    return tree_map(lambda st: shd.ShardedTensor(
        st.sharding, st.shape, st.dtype, {c: st.shards[c]}), tree)


def _bytes_at(tree, c) -> int:
    return shd.bytes_per_position(tree).get(c, 0)


@contextlib.contextmanager
def _rules(rules: dict):
    before = sharding_ctx.get_rules()
    sharding_ctx.set_rules(rules)
    try:
        yield
    finally:
        sharding_ctx.set_rules(before)


def build_cell(arch: str, shape, mesh, variant: str = "base",
               microbatch: int | None = None, model=None,
               model_pos: int = 0):
    """(``trace``, meta) of one cell: ``trace()`` runs the program of the
    first lane's position ``model_pos`` along "model" (the first, the
    fullest, by default) on meta tensors and returns its ``CostMode``;
    meta holds ``microbatch``, ``lanes`` and ``overrides``.  ``shape`` is
    a name in ``SHAPES`` or a ``ShapeCell``; ``microbatch`` overrides the
    arch's count for the shape (train), ``model`` its full-size model."""
    spec = get(arch)
    model = model or spec.make_model()
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    ov = sharding_overrides(spec, mesh, cell.kind, model)
    if variant in ("decode_tp_weights", "zero2_weights"):
        ov["embed"] = None
    if variant == "train_seq_shard":
        ov["sequence"] = "model"

    batch_shards = mesh.shape["data"] * mesh.shape.get("pod", 1)
    b_axes = shd.batch_axes(mesh)
    if cell.global_batch % batch_shards:
        b_axes = ()          # the reference's replicated batch: one lane
        ov["batch"] = None
        if cell.kind == "decode":
            ov.setdefault("kv_seq", "data")
    rules = shd.make_rules(mesh, ov)
    ctx_rules = {**rules, "batch": b_axes or None,
                 "_mesh_sizes": dict(mesh.shape)}
    defs = model.param_defs()
    params = _zeros(defs, param_pspecs(defs, rules), mesh)
    leaves = tree_leaves(params)
    lanes = steps.lane_positions(mesh, b_axes)
    at = lanes[0]
    if "model" in mesh.axis_names:
        mi = mesh.axis_names.index("model")
        at = at[:mi] + (model_pos,) + at[mi + 1:]
    meta = {"lanes": len(lanes), "overrides": repr(ov)}

    def lane_inputs(rows: int) -> dict:
        lo, hi = shd.shard_bounds(rows, len(lanes), 0)
        return spec.input_specs(ShapeCell(cell.name, cell.kind, cell.seq_len,
                                          hi - lo), model)

    if cell.kind == "train":
        mb = microbatch or pick_microbatch(spec.microbatch.get(cell.name, 1),
                                           cell.global_batch, mesh)
        opt_cfg = OptConfig()
        state = init_opt_state(params, opt_cfg)
        gacc = tree_map(lambda p: shd.zeros(p.shape, torch.float32,
                                            p.sharding), params)
        resident = (_bytes_at(params, at) + _bytes_at(state, at)
                    + _bytes_at(gacc, at))
        batch = lane_inputs(cell.global_batch // mb)
        meta["microbatch"] = mb

        def trace():
            with _rules(ctx_rules), CostMode(resident) as cm:
                g = steps.lane_group(model, mesh, at, at)
                lane_params = steps.gather_lane_params(leaves, at, g)
                with cm.repeat(mb):
                    _, grads = steps.lanes_grads(model, params,
                                                 [lane_params], [batch], [g])
                    steps.reduce_grads_at(tree_leaves(gacc),
                                          grads * len(lanes), lanes, at)
                    del grads
                del lane_params
                adamw_update(_at(params, at), _at(gacc, at), _at(state, at),
                             opt_cfg)
            return cm
        return trace, meta

    meta["microbatch"] = 1
    inputs = lane_inputs(cell.global_batch)
    if cell.kind == "prefill":
        step = steps.make_lane_prefill_step(model, spec.family, at, at)
        extras = {k: v for k, v in inputs.items() if k != "tokens"}

        def trace():
            with _rules(ctx_rules), CostMode(_bytes_at(params, at)) as cm, \
                    torch.no_grad():
                step(params, inputs["tokens"], extras or None)
            return cm
        return trace, meta

    cdefs = model.cache_defs(cell.global_batch, cell.seq_len)
    cache = _zeros(cdefs, param_pspecs(cdefs, rules), mesh)
    resident = _bytes_at(params, at) + _bytes_at(cache, at)
    step = steps.make_lane_decode_step(model, at, at)

    def trace():
        with _rules(ctx_rules), CostMode(resident) as cm, torch.no_grad():
            # cur_len as an int: a meta tensor has no value to read, and
            # the step reads every cache row whatever the fill
            step(params, cache, inputs["tokens"], cell.seq_len - 1)
        return cm
    return trace, meta


def run_cell(arch: str, shape, mesh, mesh_name: str, variant: str = "base",
             save_hlo: bool = False, microbatch: int | None = None,
             model=None) -> dict:
    """One cell's record (``build_cell``'s trace, timed)."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    rec = {"arch": arch, "shape": cell.name, "mesh": mesh_name,
           "variant": variant, "n_devices": mesh.size}
    model = model or get(arch).make_model()
    rec["scheme"] = scheme(model)
    trace, meta = build_cell(arch, cell, mesh, variant, microbatch, model)
    rec.update(meta)
    t0 = time.time()
    cm = trace()
    rec["trace_s"] = round(time.time() - t0, 2)
    s = summarize(cm.cost)
    rec["flops_per_device"] = s["flops"]
    # the convolutions' share (the Mamba2 mixer's conv): a profiler's FLOP
    # count covers matrix products only
    rec["conv_flops_per_device"] = sum(
        f for name, (_, f, _) in cm.by_op.items() if "convolution" in name)
    rec["bytes_per_device"] = s["bytes"]
    rec["collectives"] = {"bytes": s["collective_bytes"],
                          "counts": s["collective_counts"],
                          "total_bytes": s["total_collective_bytes"]}
    rec["peak_bytes_per_device"] = cm.peak
    if save_hlo:
        (ART / mesh_name).mkdir(parents=True, exist_ok=True)
        rows = sorted(cm.by_op.items(), key=lambda kv: -kv[1][2])
        (ART / mesh_name / f"{arch}__{cell.name}__{variant}.ops.txt"
         ).write_text("op calls flops bytes\n" + "".join(
             f"{name} {n} {f:.6g} {b:.6g}\n" for name, (n, f, b) in rows))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--variant", default="base")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's per-op counts (<tag>.ops.txt)")
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"),
                                device="meta")
    mesh_name = args.mesh
    outdir = ART / mesh_name
    outdir.mkdir(parents=True, exist_ok=True)

    archs = [args.arch] if args.arch else all_archs()
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        spec = get(arch)
        shapes = [args.shape] if args.shape else spec.shapes
        for shape in shapes:
            if shape not in spec.shapes:
                continue
            tag = f"{arch}__{shape}" + (
                "" if args.variant == "base" else f"__{args.variant}")
            path = outdir / f"{tag}.json"
            if path.exists() and not args.force:
                n_skip += 1
                continue
            print(f"[dryrun:{mesh_name}] {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mesh, mesh_name, args.variant,
                               args.save_hlo)
                rec["ok"] = True
                path.write_text(json.dumps(rec, indent=1))
                path.with_suffix(".error.json").unlink(missing_ok=True)
                print(f"  ok: flops/dev={rec['flops_per_device']:.3e}"
                      f" bytes/dev={rec['bytes_per_device']:.3e}"
                      f" coll={rec['collectives']['total_bytes']:.3e}B"
                      f" peak={rec['peak_bytes_per_device'] / 2**30:.2f}GiB"
                      f" trace={rec['trace_s']}s", flush=True)
                n_ok += 1
            except Exception as e:
                n_fail += 1
                err = {"arch": arch, "shape": shape, "mesh": mesh_name,
                       "variant": args.variant, "ok": False,
                       "error": f"{type(e).__name__}: {e}"[:2000]}
                path.with_suffix(".error.json").write_text(
                    json.dumps(err, indent=1))
                print(f"  FAIL: {type(e).__name__}: {str(e)[:300]}",
                      flush=True)
    print(f"[dryrun:{mesh_name}] done ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
