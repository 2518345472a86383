"""A data lane's prefill and greedy decode with its compute split over the
"model" positions (``runtime/steps.make_lane_prefill_step`` /
``make_lane_decode_step`` inside their ``ModelGroup``) against the unsplit
lane (the model run whole on the lane's rows), for the ten smoke archs on
(1, 2), (2, 2) and (1, 4) CPU meshes and whisper on (1, 3) too (its 4
heads padded to 6, its vocab and kv heads whole), the parameters and cache
laid out by the dry run's overrides for the smoke config.  Every arch's
lane splits (``model_split``), zamba2-7b's too: its Mamba2 state and conv
window, its shared block's KV caches split over "model", and a decode
step writes its rows into the positions' blocks.  The leaves that stay at
their init values (norm scales, the SSM's decay, step bias and skip, the
LoRA's zero up-projection) are redrawn so that they matter.

Tolerances, stated once: float32 logits and cache rows within ``TOL`` x
(1 + |unsplit value|); greedy tokens equal.
"""
import dataclasses
import math

import _torch_cpu  # noqa: F401
import pytest
import torch

from repro_torch.configs import get
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import sharding_ctx
from repro_torch.models.params import init_params, param_pspecs, tree_map
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps

TOL = 1e-4
ARCHS = ["qwen3-1.7b", "gemma-7b", "granite-8b", "deepseek-v2-lite-16b",
         "deepseek-67b", "llama4-scout-17b-a16e", "mamba2-1.3b",
         "zamba2-7b", "whisper-large-v3", "pixtral-12b"]
MESHES = [(1, 2), (2, 2), (1, 4)]
CASES = [(a, m) for a in ARCHS for m in MESHES] + [
    ("whisper-large-v3", (1, 3))]
B, S, MAX, GEN = 4, 8, 16, 4
REDRAWN = ("scale", "a_log", "dt_bias", "d_skip", "ffn_b")


def _close(got: torch.Tensor, want: torch.Tensor) -> bool:
    return bool(((got - want).abs() <= TOL * (1 + want.abs())).all())


def _whole(x) -> torch.Tensor:
    return (torch.cat(x.parts, x.dim) if sharding_ctx.is_blocks(x)
            else x)


def _f32(model):
    """The smoke model in float32 (a VLM's text backbone)."""
    cfg = model.cfg
    if hasattr(cfg, "lm"):
        return type(model)(dataclasses.replace(cfg, lm=dataclasses.replace(
            cfg.lm, dtype=torch.float32)))
    return type(model)(dataclasses.replace(cfg, dtype=torch.float32))


def _redraw(tree, gen, name=""):
    if isinstance(tree, dict):
        return {k: _redraw(v, gen, k) for k, v in tree.items()}
    if name in REDRAWN:
        return 0.5 * torch.randn(tree.shape, generator=gen)
    return tree


def _extras(family: str, model, rows: int, gen) -> dict:
    """The stub frontend's input: patches (VLM), frames (encdec)."""
    c = model.cfg
    if family == "vlm":
        return {"patches": 0.1 * torch.randn(
            (rows, c.n_patches, c.d_vit), generator=gen)}
    if family == "encdec":
        return {"frames": 0.1 * torch.randn(
            (rows, c.n_frames, c.d_model), generator=gen)}
    return {}


def _n_split(defs, rules, m: int) -> int:
    """The cache leaves whose layout puts a dim that divides by ``m`` on
    "model"."""
    return sum(any(rules.get(a) == "model" and n % m == 0
                   for a, n in zip(d.axes, d.shape))
               for d in steps.tree_leaves(defs))


@pytest.mark.parametrize("arch,shape", CASES, ids=[
    f"{a}-shape{MESHES.index(m) if m in MESHES else len(MESHES)}"
    for a, m in CASES])
def test_split_lane_equals_the_unsplit_lane(arch, shape):
    spec = get(arch)
    model = _f32(spec.make_smoke())
    defs = model.param_defs()
    gen = torch.Generator().manual_seed(1)
    plain = _redraw(init_params(defs, 0, "cpu"), gen)
    mesh = make_host_mesh(*shape, device="cpu")
    rules = shd.make_rules(mesh, dryrun.sharding_overrides(
        spec, mesh, "decode", model))
    params = shd.device_put(plain, shd.named(mesh, param_pspecs(defs,
                                                                rules)))
    vocab = getattr(model.cfg, "lm", model.cfg).vocab
    toks = torch.randint(0, vocab, (B, S), generator=gen, dtype=torch.int32)
    extras = _extras(spec.family, model, B, gen)
    prefix = model.cfg.n_patches if spec.family == "vlm" else 0
    lanes = steps.lane_positions(mesh)
    lane, rows = lanes[-1], B // len(lanes)
    sl = slice((len(lanes) - 1) * rows, len(lanes) * rows)
    ex = {k: v[sl] for k, v in extras.items()} or None
    prefill = steps.make_prefill_step(model, spec.family)
    g = steps.lane_group(model, mesh, lane)
    assert model.model_split and g.size == shape[1]
    with torch.no_grad():
        want, wcache = prefill(plain, toks[sl], ex, MAX + prefix)
        sharding_ctx.set_rules({**rules, "_mesh_sizes": mesh.shape})
        try:
            got, cache = steps.make_lane_prefill_step(
                model, spec.family, lane)(params, toks[sl], ex, MAX + prefix)
            assert _close(got, want)
            split = 0
            for a, b in zip(steps.tree_leaves(cache),
                            steps.tree_leaves(wcache)):
                split += sharding_ctx.is_blocks(a)
                assert _close(_whole(a), b)
            cdefs = model.cache_defs(B, MAX + prefix)
            assert split == _n_split(cdefs, rules, shape[1])
            assert split or shape == (1, 3)

            # greedy decode from the whole prefill's cache of every row
            _, full = prefill(plain, toks, extras or None, MAX + prefix)
            scache = shd.device_put(full, shd.named(
                mesh, param_pspecs(cdefs, rules)))
            pcache = tree_map(lambda t, d: t.narrow(
                d.axes.index("batch"), sl.start, rows).clone(), full, cdefs)
            decode = steps.make_lane_decode_step(model, lane)
            t = t0 = toks[sl, -1:]
            for i in range(GEN):
                got, _ = decode(params, scache, t, prefix + S + i)
                want, pcache = model.decode_step(plain, pcache, t0,
                                                 prefix + S + i)
                assert _close(got, want), i
                t = got.argmax(-1, keepdim=True).to(torch.int32)
                t0 = want.argmax(-1, keepdim=True).to(torch.int32)
                assert torch.equal(t, t0), i
            # the rows the split decode wrote stayed in the shards
            lanes_rows = tree_map(lambda st, d: shd.gather(
                st, "cpu", at=lane, rows=d.axes.index("batch")), scache,
                cdefs)
            for a, b in zip(steps.tree_leaves(lanes_rows),
                            steps.tree_leaves(pcache)):
                assert _close(a, b)
        finally:
            sharding_ctx.set_rules(None)


def _cli_split(arch: str, mesh: str, every_step: bool = True) -> None:
    """``launch.train --mesh <mesh> --device cpu``: the arch's smoke run
    split over the mesh's "model" positions, its losses (``every_step``,
    else the first; the rest finite) within the reference's mesh-test
    tolerances (rtol = atol = 2e-4) of the one-position run."""
    from repro_torch.launch import train
    argv = ["--arch", arch, "--preset", "smoke", "--steps", "4",
            "--global-batch", "4", "--seq-len", "32", "--microbatches",
            "2", "--log-every", "100", "--device", "cpu"]
    split = train.run(train.parse_args(argv + ["--mesh", mesh]))
    one = train.run(train.parse_args(argv))
    d, m = (int(v) for v in mesh.split(","))
    assert split["mesh"].shape == {"data": d, "model": m}
    assert one["mesh"].shape == {"data": 1, "model": 1}
    if d == 1 and every_step:
        assert split["losses"][0] == one["losses"][0]
    assert all(math.isfinite(v) for v in split["losses"])
    for a, b in zip(split["losses"], one["losses"][:None if every_step
                                                    else 1]):
        assert abs(a - b) <= 2e-4 + 2e-4 * abs(b), (a, b)


def test_train_cli_mesh_flag_runs_the_split():
    """qwen3-1.7b on (1, 4)."""
    _cli_split("qwen3-1.7b", "1,4")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b",
                                  "whisper-large-v3", "pixtral-12b"])
def test_train_cli_mesh_flag_splits_every_family(arch):
    """The other families on (1, 2), as the docs show for mamba2: the first
    loss (the bf16 smoke models' later steps amplify the float32 sums'
    other order)."""
    _cli_split(arch, "1,2", every_step=False)
