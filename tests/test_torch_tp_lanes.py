"""A data lane's prefill and greedy decode with its compute split over the
"model" positions (``runtime/steps.make_lane_prefill_step`` /
``make_lane_decode_step`` inside their ``ModelGroup``) against the unsplit
lane (the model run whole on the lane's rows), for the six dense and MoE
smoke archs on (1, 2), (2, 2) and (1, 4) CPU meshes, the parameters and
cache laid out by the dry run's overrides for the smoke config.

Tolerances, stated once: float32 logits and cache rows within ``TOL`` x
(1 + |unsplit value|); greedy tokens equal.
"""
import dataclasses

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
ARCHS = ["qwen3-1.7b", "gemma-7b", "granite-8b", "deepseek-67b",
         "deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]
MESHES = [(1, 2), (2, 2), (1, 4)]
B, S, MAX, GEN = 4, 8, 16, 4


def _close(got: torch.Tensor, want: torch.Tensor) -> bool:
    return bool(((got - want).abs() <= TOL * (1 + want.abs())).all())


def _whole(x) -> torch.Tensor:
    return (torch.cat(x.parts, x.dim) if sharding_ctx.is_blocks(x)
            else x)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_lane_equals_the_unsplit_lane(arch, shape):
    spec = get(arch)
    smoke = spec.make_smoke()
    model = type(smoke)(dataclasses.replace(smoke.cfg, dtype=torch.float32))
    defs = model.param_defs()
    plain = init_params(defs, 0, "cpu")
    mesh = make_host_mesh(*shape, device="cpu")
    rules = shd.make_rules(mesh, dryrun.sharding_overrides(
        spec, mesh, "decode", model))
    params = shd.device_put(plain, shd.named(mesh, param_pspecs(defs,
                                                                rules)))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (B, S), generator=gen,
                         dtype=torch.int32)
    lanes = steps.lane_positions(mesh)
    lane, rows = lanes[-1], B // len(lanes)
    sl = slice((len(lanes) - 1) * rows, len(lanes) * rows)
    assert steps.lane_group(model, mesh, lane).size == shape[1]
    with torch.no_grad():
        want, wcache = model.prefill(plain, toks[sl], max_len=MAX)
        sharding_ctx.set_rules({**rules, "_mesh_sizes": mesh.shape})
        try:
            got, cache = steps.make_lane_prefill_step(
                model, spec.family, lane)(params, toks[sl], None, MAX)
            assert _close(got, want)
            split = 0
            for a, b in zip(steps.tree_leaves(cache),
                            steps.tree_leaves(wcache)):
                split += sharding_ctx.is_blocks(a)
                assert _close(_whole(a), b)
            assert split == len(steps.tree_leaves(wcache))  # every leaf

            # greedy decode from the whole prefill's cache of every row
            _, full = model.prefill(plain, toks, max_len=MAX)
            cdefs = model.cache_defs(B, MAX)
            scache = shd.device_put(full, shd.named(
                mesh, param_pspecs(cdefs, rules)))
            pcache = tree_map(lambda t: t[:, sl].clone(), full)
            decode = steps.make_lane_decode_step(model, lane)
            t = t0 = toks[sl, -1:]
            for i in range(GEN):
                got, _ = decode(params, scache, t, S + i)
                want, pcache = model.decode_step(plain, pcache, t0, S + i)
                assert _close(got, want), i
                t = got.argmax(-1, keepdim=True).to(torch.int32)
                t0 = want.argmax(-1, keepdim=True).to(torch.int32)
                assert torch.equal(t, t0), i
            # the rows the split decode wrote stayed in the shards
            lanes_rows = tree_map(lambda st, d: shd.gather(
                st, "cpu", at=lane, rows=1), scache, cdefs)
            for a, b in zip(steps.tree_leaves(lanes_rows),
                            steps.tree_leaves(pcache)):
                assert _close(a, b)
        finally:
            sharding_ctx.set_rules(None)


def test_train_cli_mesh_flag_runs_the_split():
    """``launch.train --mesh 1,4 --device cpu``: qwen3's smoke run on four
    "model" positions, its losses within the reference's mesh-test
    tolerances (rtol = atol = 2e-4) of the one-position run."""
    from repro_torch.launch import train
    argv = ["--preset", "smoke", "--steps", "4", "--global-batch", "4",
            "--seq-len", "32", "--microbatches", "2", "--log-every", "100",
            "--device", "cpu"]
    split = train.run(train.parse_args(argv + ["--mesh", "1,4"]))
    one = train.run(train.parse_args(argv))
    assert split["mesh"].shape == {"data": 1, "model": 4}
    assert one["mesh"].shape == {"data": 1, "model": 1}
    assert split["losses"][0] == one["losses"][0]
    for a, b in zip(split["losses"], one["losses"]):
        assert abs(a - b) <= 2e-4 + 2e-4 * abs(b), (a, b)
