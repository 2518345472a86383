"""Shared set-up of the sharded-training parity tests
(``tests/test_torch_train_mesh_{dense,moe,ssm,multimodal}.py``): the port's
data-parallel step on CPU meshes of positions against the reference's
jitted single-device ``make_train_step`` (the reference's own mesh test
fails on this tree's jax, ROADMAP Queue 3), on the reference's weights
(``_families.pair``) and its own data stream.

Tolerances, stated once:
  * float32, against the port's own one-device step on the same weights
    and batches (what sharding must not change): every step's loss, grad
    norm and lr within rtol ``F32_RTOL``, every parameter after the last
    step within ``F32_PARAM_ATOL``;
  * float32, against the reference: the metrics within rtol ``F32_RTOL``
    (the hybrid within ``HYBRID_RTOL``: its one-device port already
    differs by 3e-4 at step 1, an ulp amplified, ROADMAP Queue 3), and the
    parameters within ``2 x lr`` per step (AdamW moves a parameter by about
    lr whatever its gradient's size, so a near-zero gradient whose sign
    rounds the other way moves it 2 lr apart);
  * bf16: one sharded microbatch-gradient pass against the reference run
    op by op, within ``tests/_train.py``'s bf16 tolerances (the lanes
    round their bf16 gradients apart before the float32 sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _families import frontend, leaves, pair, vocab
from repro.runtime import data as jdata
from repro.runtime import optim as joptim
from repro.runtime import steps as jsteps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import sharding_ctx
from repro_torch.models.params import param_pspecs
from repro_torch.runtime import optim
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.steps import make_train_step

MESHES = [(2, 2), (1, 4), (4, 1)]
STEPS, B, S = 3, 4, 24
F32_RTOL = 1e-4
F32_PARAM_ATOL = 1e-4
HYBRID_RTOL = 1e-3
PEAK_LR = 1e-3


def ref_batches(arch, model, n=STEPS, seed=5):
    """The reference's data stream (its own ``DataPipeline``) plus the stub
    frontend's input drawn with numpy, as numpy."""
    pipe = jdata.DataPipeline(jdata.DataConfig(vocab=vocab(model), seq_len=S,
                                               global_batch=B, seed=seed))
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = {k: np.asarray(v) for k, v in pipe.batch_at(i).items()}
        b.update(frontend(arch, model, B, rng)[0])
        out.append(b)
    return out


def on_mesh(model, params, shape):
    """(params as ``ShardedTensor``s on a CPU mesh of ``shape``, the mesh,
    the rules with the mesh sizes as the launcher installs them)."""
    mesh = make_host_mesh(*shape, device="cpu")
    rules = shd.make_rules(mesh)
    specs = param_pspecs(model.param_defs(), rules)
    return (shd.device_put(params, shd.named(mesh, specs)), mesh,
            {**rules, "_mesh_sizes": mesh.shape})


def _run(step, params, state, batches, rules=None):
    """Feed ``batches`` through ``step``; returns (params, state, per-step
    metrics as floats)."""
    mets = []
    sharding_ctx.set_rules(rules)
    try:
        for b in batches:
            params, state, met = step(params, state, {
                n: torch.from_numpy(v.copy()) for n, v in b.items()})
            mets.append({n: float(v) for n, v in met.items()})
    finally:
        sharding_ctx.set_rules(None)
    return params, state, mets


def _close(got, want, rtol, label):
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("loss", "grad_norm", "lr"):
            assert abs(g[name] - w[name]) <= rtol * abs(w[name]), \
                (label, i, name, g[name], w[name])


def _max_diff(a: dict, b: dict, atol: float, label) -> float:
    assert a.keys() == b.keys()
    worst = 0.0
    for path, t in a.items():
        if t.size:
            err = float(np.abs(t - b[path]).max())
            assert err <= atol, (label, path, err)
            worst = max(worst, err)
    return worst


def _np(tree) -> dict:
    return {k: v.float().numpy() for k, v in leaves(tree)}


def check_trajectory(arch, k, meshes=MESHES, compress=False) -> dict:
    """3 steps of the reference's jitted single-device step, of the port's
    one-device step and of its sharded step on each mesh, from the same
    float32 weights and batches; asserts the float32 tolerances above and
    returns the worst errors."""
    jm, jp, m, p = pair(arch, f32=True)
    kw = dict(peak_lr=PEAK_LR, warmup_steps=2, total_steps=10,
              compress_grads=compress)
    jcfg, cfg = joptim.OptConfig(**kw), optim.OptConfig(**kw)
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, microbatches=k,
                                           batch_axes=None))
    batches = ref_batches(arch, m)
    jstate, jmets = joptim.init_opt_state(jp, jcfg), []
    for i, b in enumerate(batches):
        jp, jstate, jmet = jstep(jp, jstate, jax.tree.map(jnp.asarray, b),
                                 jnp.uint32(i))
        jmets.append({n: float(v) for n, v in jmet.items()})
    want = dict(leaves(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                    jp)))
    step = make_train_step(m, cfg, microbatches=k)
    p1 = optim.tree_map(torch.clone, p)
    p1, _, mets1 = _run(step, p1, optim.init_opt_state(p1, cfg), batches)
    one = _np(p1)
    ref_rtol = HYBRID_RTOL if arch == "zamba2-7b" else F32_RTOL
    worst = {"vs_one_device": 0.0, "vs_reference": 0.0}
    for shape in meshes:
        sp, mesh, rules = on_mesh(m, optim.tree_map(torch.clone, p), shape)
        sp, state, mets = _run(step, sp, optim.init_opt_state(sp, cfg),
                               batches, rules)
        assert int(next(iter(state["step"].shards.values()))) == STEPS
        _close(mets, mets1, F32_RTOL, (shape, "one device"))
        _close(mets, jmets, ref_rtol, (shape, "reference"))
        got = _np(shd.gather_tree(sp, "cpu"))
        worst["vs_one_device"] = max(worst["vs_one_device"], _max_diff(
            got, one, F32_PARAM_ATOL, (shape, "one device")))
        worst["vs_reference"] = max(worst["vs_reference"], _max_diff(
            got, want, 2 * PEAK_LR * STEPS, (shape, "reference")))
    return worst


def check_bf16_grads(arch, shape=(2, 2), k=2) -> float:
    """One sharded microbatch-gradient pass of the bf16 smoke model on a
    CPU mesh against the reference's gradients, run op by op (as
    ``tests/_train.py``); returns the worst leaf's error over its scale."""
    from _train import (BF16_GRAD_TOL, BF16_LOSS_TOL, HYBRID_GRAD_TOL,
                        batches)
    from repro_torch.runtime.steps import sharded_microbatch_grads
    fields = dict(n_blocks=13) if arch == "zamba2-7b" else {}
    jm, jp, m, p = pair(arch, **fields)
    jb, tb = batches(arch, m, bf16=True)
    jb = {n: jnp.concatenate([v, v]) for n, v in jb.items()}   # 4 rows
    tb = {n: torch.cat([v, v]) for n, v in tb.items()}
    rows = jb["tokens"].shape[0] // k
    fn = jax.value_and_grad(lambda pp: jnp.mean(jnp.stack(
        [jm.train_loss(pp, {n: v[i * rows:(i + 1) * rows]
                            for n, v in jb.items()})[0]
         for i in range(k)])))
    with jax.disable_jit():
        jl, jg = fn(jp)
    sp, _, rules = on_mesh(m, p, shape)
    sharding_ctx.set_rules(rules)
    try:
        tl, tg = sharded_microbatch_grads(m, sp, tb, k)
    finally:
        sharding_ctx.set_rules(None)
    assert abs(float(tl) - float(jl)) <= BF16_LOSS_TOL, (float(tl), float(jl))
    tol = HYBRID_GRAD_TOL if arch == "zamba2-7b" else BF16_GRAD_TOL
    ref = dict(leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), jg)))
    got = dict(leaves(shd.gather_tree(tg, "cpu")))
    assert got.keys() == ref.keys()
    worst = 0.0
    for path, g in got.items():
        r = ref[path]
        if r.size == 0:
            continue
        scale = max(float(np.abs(r).max()), 1e-6)
        err = float(np.abs(g.numpy() - r).max())
        assert g.dtype == torch.float32 and err <= tol * scale, \
            (path, err, scale)
        worst = max(worst, err / scale)
    return worst
