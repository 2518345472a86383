"""The dry run (``repro_torch/launch/dryrun.py``), its registry grid
(``configs/registry.py``), the position-crossing byte counter
(``runtime/sharding.count_transfers``) and the roofline
(``benchmarks/roofline.py``) against the reference's.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so its pure functions are compared in a subprocess, never in a
test worker.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import _torch_cpu  # noqa: F401
import pytest
import torch

from benchmarks import roofline as j_roofline
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get as j_get
from repro.configs import grid as j_grid
from repro_torch.benchmarks import roofline
from repro_torch.configs import SHAPES, ShapeCell, all_archs, get, grid
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import CostMode
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import param_pspecs, tree_leaves
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps
from repro_torch.runtime.optim import OptConfig, init_opt_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


class ShapeOnly:
    """A mesh stand-in: the functions compared read ``mesh.shape`` only."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tuple(tree.shape), str(tree.dtype).split(".")[-1]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_grid_equals_the_reference():
    assert grid() == j_grid()
    assert {n: (c.kind, c.seq_len, c.global_batch)
            for n, c in SHAPES.items()} == {
        n: (c.kind, c.seq_len, c.global_batch) for n, c in J_SHAPES.items()}


@pytest.mark.parametrize("arch", all_archs())
def test_input_and_cache_specs_equal_the_reference(arch):
    spec, jspec = get(arch), j_get(arch)
    for shape in spec.shapes:
        got = spec.input_specs(shape)
        want = jspec.input_specs(shape)
        assert list(_leaves(got)) == list(_leaves(want)), shape
        assert all(t.device.type == "meta" for t in got.values())
        assert list(_leaves(spec.cache_specs(shape))) == list(
            _leaves(jspec.cache_specs(shape))), shape


# ---------------------------------------------------------------------------
# sharding_overrides / pick_microbatch against the reference (subprocess)
# ---------------------------------------------------------------------------

_REF_SCRIPT = """
import json, sys
from repro.configs import SHAPES, get, grid
import repro.launch.dryrun as R
class M:
    def __init__(self, shape): self.shape = shape
meshes = json.loads(sys.argv[1])
out = {}
for name, shape in meshes.items():
    for arch, s in grid():
        spec, cell = get(arch), SHAPES[s]
        for kind in ("train", "prefill", "decode"):
            out[f"{name}/{arch}/{s}/{kind}"] = repr(
                R.sharding_overrides(spec, M(shape), kind))
        out[f"{name}/{arch}/{s}/mb"] = R.pick_microbatch(
            spec.microbatch.get(s, 1), cell.global_batch, M(shape))
print(json.dumps(out))
"""


def test_overrides_and_microbatch_equal_the_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                        json.dumps(MESHES)], capture_output=True, text=True,
                       env=env, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout.strip().splitlines()[-1])
    got = {}
    for name, shape in MESHES.items():
        for arch, s in grid():
            spec, cell = get(arch), SHAPES[s]
            for kind in ("train", "prefill", "decode"):
                got[f"{name}/{arch}/{s}/{kind}"] = repr(
                    dryrun.sharding_overrides(spec, ShapeOnly(shape), kind))
            got[f"{name}/{arch}/{s}/mb"] = dryrun.pick_microbatch(
                spec.microbatch.get(s, 1), cell.global_batch,
                ShapeOnly(shape))
    assert got == want


# ---------------------------------------------------------------------------
# Bytes that cross between positions
# ---------------------------------------------------------------------------

def _mesh():
    return make_mesh((2, 2), ("data", "model"), device="cpu")


def test_gather_counts_the_blocks_from_other_positions():
    mesh = _mesh()
    x = torch.arange(5 * 6, dtype=torch.float32).reshape(5, 6)
    st = shd.put(x, shd.NamedSharding(mesh, shd.P("data", "model")))
    at = (1, 0)
    with shd.count_transfers() as rec:
        full = shd.gather(st, "cpu", at=at)
    assert torch.equal(full, x)
    # rows [3, 5) x cols [0, 3) are at's own block; the rest crosses
    own = (5 - 3) * 3 * 4
    assert rec.bytes["all-gather"] == x.numel() * 4 - own
    assert rec.counts["all-gather"] == 3
    assert sum(rec.bytes.values()) == rec.bytes["all-gather"]

    # a's rows of a "cache": only the positions holding at's row block
    with shd.count_transfers() as rec:
        rows = shd.gather(st, "cpu", at=at, rows=0)
    assert torch.equal(rows, x[3:5])
    assert rec.bytes["all-gather"] == 2 * 3 * 4        # from (1, 1)

    # a leaf replicated over "model": at's own copy, nothing moves
    rep = shd.put(x, shd.NamedSharding(mesh, shd.P(None, None)))
    with shd.count_transfers() as rec:
        got = shd.gather(rep, "cpu", at=(1, 1))
    assert got is rep.shards[(1, 1)]
    assert sum(rec.bytes.values()) == 0
    # without ``at`` nothing is counted (a copy off the mesh)
    with shd.count_transfers() as rec:
        shd.gather(st, "cpu")
    assert sum(rec.bytes.values()) == 0


def test_put_counts_copies_off_the_first_position():
    mesh = _mesh()
    x = torch.zeros(5, 6)
    with shd.count_transfers() as rec:
        shd.put(x, shd.NamedSharding(mesh, shd.P("data", None)))
    # (0, 0) keeps rows [0, 3); (0, 1) gets them again, (1, *) rows [3, 5)
    assert rec.bytes["collective-permute"] == (3 * 6 + 2 * 2 * 6) * 4
    assert rec.counts["collective-permute"] == 3


def test_reduce_scatter_counts_float32_blocks_from_other_lanes():
    mesh = _mesh()
    sh = shd.NamedSharding(mesh, shd.P("data", "model"))
    gacc = [shd.zeros((5, 6), torch.float32, sh)]
    lanes = steps.lane_positions(mesh)
    assert lanes == [(0, 0), (1, 0)]
    g = [torch.ones(5, 6, dtype=torch.bfloat16)]
    with shd.count_transfers() as rec:
        for c in mesh.positions():
            steps.reduce_grads_at(gacc, [g, g], lanes, c)
    # every position receives its block from each lane but the one at it:
    # (0, 0) from lane (1, 0), (1, 0) from lane (0, 0), (0, 1) and (1, 1)
    # from both
    blocks = {c: math.prod(t.shape) for c, t in gacc[0].shards.items()}
    want = 4 * (blocks[(0, 0)] + blocks[(1, 0)]
                + 2 * blocks[(0, 1)] + 2 * blocks[(1, 1)])
    assert rec.bytes["reduce-scatter"] == want
    assert torch.equal(shd.gather(gacc[0], "cpu"), torch.full((5, 6), 2.0))


def test_counting_is_off_outside_the_block():
    mesh = _mesh()
    st = shd.put(torch.zeros(4, 4),
                 shd.NamedSharding(mesh, shd.P("data", "model")))
    with shd.count_transfers() as rec:
        pass
    shd.gather(st, "cpu", at=(0, 0))
    assert sum(rec.bytes.values()) == 0


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------

def _replicated_width(model) -> int:
    """The output widths, summed over the layers, of the projections every
    "model" position computes whole: MLA's latent projections (``wdkv``,
    ``wkr``) and the MoE router."""
    c = model.cfg
    width = c.n_layers * (c.mla_kv_rank + c.mla_qk_rope) \
        if c.attention == "mla" else 0
    return width + sum(n for kind, n in c.groups() if kind == "moe") * \
        c.n_experts


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_one_lane_stands_for_all(arch):
    """On a (2, 2) mesh at smoke size, the dry run's per-position FLOPs x
    the positions equal the FLOPs of the whole ``make_train_step`` call,
    less what the "model" positions' programs each repeat and the lane
    runs once: the replicated projections, forward, recompute and the two
    products of their backward."""
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    model = get(arch).make_smoke()
    cell = ShapeCell("smoke", "train", 32, 8)
    rec = dryrun.run_cell(arch, cell, mesh, "2x2", microbatch=2,
                          model=model)
    assert rec["lanes"] == 2 and rec["microbatch"] == 2

    rules = shd.make_rules(mesh, dryrun.sharding_overrides(
        get(arch), mesh, "train"))
    defs = model.param_defs()
    params = dryrun._zeros(defs, param_pspecs(defs, rules), mesh)
    opt = OptConfig()
    state = init_opt_state(params, opt)
    batch = get(arch).input_specs(cell)
    with dryrun._rules({**rules, "_mesh_sizes": dict(mesh.shape)}), \
            CostMode() as cm:
        steps.make_train_step(model, opt, 2)(params, state, batch)
    m, rows = mesh.shape["model"], cell.global_batch // 2 // rec["lanes"]
    repeated = (m - 1) * rec["lanes"] * 2 * 4 * 2 * rows * cell.seq_len * \
        model.cfg.d_model * _replicated_width(model)
    assert rec["flops_per_device"] * rec["lanes"] * m - repeated == \
        cm.cost.flops
    assert (repeated == 0) == (arch == "qwen3-1.7b")
    assert rec["flops_per_device"] > 0
    # the lane's gather and its share of the reduce-scatter cross
    assert rec["collectives"]["bytes"]["all-gather"] > 0
    assert rec["collectives"]["bytes"]["reduce-scatter"] > 0
    leaves = tree_leaves(params)
    assert rec["peak_bytes_per_device"] > sum(
        p.shards[(0, 0)].numel() * p.shards[(0, 0)].element_size()
        for p in leaves)


def test_replicated_batch_runs_one_lane_over_every_row():
    """long_500k at batch 1 does not split over 16 lanes: every position
    runs the whole batch (the reference's replicated batch)."""
    mesh = make_mesh((16, 16), ("data", "model"), device="meta")
    rec = dryrun.run_cell("mamba2-1.3b", "long_500k", mesh, "single")
    assert rec["lanes"] == 1
    assert "'batch': None" in rec["overrides"]
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0


def test_main_writes_complete_records_and_restarts(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    monkeypatch.setattr(roofline, "ART", tmp_path)
    argv = ["--mesh", "single", "--arch", "mamba2-1.3b", "--shape",
            "decode_32k", "--save-hlo"]
    assert dryrun.main(argv) == 0
    rec = json.loads((tmp_path / "single" /
                      "mamba2-1.3b__decode_32k.json").read_text())
    for key in ("arch", "shape", "mesh", "variant", "n_devices",
                "microbatch", "lanes", "overrides", "scheme",
                "flops_per_device", "bytes_per_device", "collectives",
                "peak_bytes_per_device", "trace_s"):
        assert key in rec, key
    assert rec["ok"] and rec["n_devices"] == 256
    assert rec["scheme"] == dryrun.SCHEME_SPLIT
    assert set(rec["collectives"]) == {"bytes", "counts", "total_bytes"}
    for key in ("flops_per_device", "bytes_per_device",
                "peak_bytes_per_device"):
        assert math.isfinite(rec[key]) and rec[key] > 0
    assert (tmp_path / "single" /
            "mamba2-1.3b__decode_32k__base.ops.txt").exists()
    assert dryrun.main(argv) == 0
    assert "skip=1" in capsys.readouterr().out
    roofline.main(["--mesh", "single"])
    out = capsys.readouterr().out
    assert "| mamba2-1.3b | decode_32k | base |" in out
    assert "worst roofline fraction" in out


# ---------------------------------------------------------------------------
# The roofline against the reference's
# ---------------------------------------------------------------------------

def test_model_flops_equal_the_reference():
    for arch, shape in grid():
        for n in (1, 256, 512):
            assert roofline.model_flops_per_device(arch, shape, n) == \
                j_roofline.model_flops_per_device(arch, shape, n)


def test_analyze_record_equals_the_reference_with_the_h100_rates():
    rec = {"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "single",
           "variant": "base", "n_devices": 256, "flops_per_device": 3.1e15,
           "bytes_per_device": 2.7e13,
           "collectives": {"total_bytes": 5.5e10},
           "peak_bytes_per_device": 17 * 2**30}
    got, want = roofline.analyze_record(rec), j_roofline.analyze_record(rec)
    assert set(got) == set(want)
    scale = {"compute_s": j_roofline.PEAK_FLOPS / roofline.PEAK_FLOPS,
             "memory_s": j_roofline.HBM_BW / roofline.HBM_BW,
             "collective_s": j_roofline.LINK_BW / roofline.LINK_BW}
    for k, f in scale.items():
        assert got[k] == pytest.approx(want[k] * f, rel=1e-12), k
    for k in ("arch", "shape", "variant", "mesh", "chips",
              "model_flops_per_dev", "useful_ratio", "peak_gib"):
        assert got[k] == want[k], k
    terms = {k: got[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert got["dominant"] == max(terms, key=terms.get)
    assert got["roofline_frac"] == pytest.approx(
        got["model_flops_per_dev"] / roofline.PEAK_FLOPS / max(
            terms.values()), rel=1e-12)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989.4e12, 3.35e12, 450e9)

