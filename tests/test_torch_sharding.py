"""The port's sharding rules and per-position shards against the JAX
package's ``runtime/sharding.py``, ``models/params.param_pspecs`` and
``runtime/optim.opt_state_pspecs``: every spec of every smoke arch equal
as tuples; ``make_rules`` / ``batch_axes`` on 2-D and 3-D meshes;
shard-then-gather the identity (uneven splits included); the sharded
packs' specs; ``CheckpointManager.restore(shardings=)`` from a
checkpoint the reference wrote, bit for bit; meshes of any rank and the
ambient mesh of ``use_mesh``."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.configs import get as j_get  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.models.params import param_pspecs as j_param_pspecs  # noqa: E402
from repro.runtime import optim as joptim  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models.params import P, from_numpy, param_pspecs  # noqa
from repro_torch.runtime import optim  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402

MESHES = {"2d": ((1, 1), ("data", "model")),
          "3d": ((1, 1, 1), ("pod", "data", "model"))}


def _tuples(tree):
    """A spec tree (either package's) as nested dicts of tuples."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _meshes(kind):
    shape, axes = MESHES[kind]
    return jax.make_mesh(shape, axes), make_mesh(shape, axes, device="cpu")


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_rules_and_batch_axes_match_reference(kind):
    jmesh, mesh = _meshes(kind)
    assert shd.batch_axes(mesh) == jshd.batch_axes(jmesh)
    assert shd.mesh_axes(mesh) == jshd.mesh_axes(jmesh)
    over = {"embed": None, "vocab": "data"}
    for o in (None, over):
        assert shd.make_rules(mesh, o) == jshd.make_rules(jmesh, o)


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", all_archs())
def test_specs_match_reference(arch, kind):
    """param / cache / input / optimizer-state PartitionSpecs, as tuples."""
    jmesh, mesh = _meshes(kind)
    jm, m = j_get(arch).make_smoke(), get(arch).make_smoke()
    assert _tuples(shd.model_param_pspecs(m, mesh)) == \
        _tuples(jshd.model_param_pspecs(jm, jmesh))
    assert _tuples(shd.cache_pspecs(m, mesh, 2, 16)) == \
        _tuples(jshd.cache_pspecs(jm, jmesh, 2, 16))
    specs = {"tokens": torch.zeros(2, 8), "cur_len": torch.tensor(3),
             "frames": torch.zeros(2, 4, 8)}
    jspecs = {n: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
              for n, v in specs.items()}
    assert _tuples(shd.input_pspecs(specs, mesh)) == \
        _tuples(jshd.input_pspecs(jspecs, jmesh))
    for compress in (False, True):
        ps = param_pspecs(m.param_defs(), shd.make_rules(mesh))
        jps = j_param_pspecs(jm.param_defs(), jshd.make_rules(jmesh))
        got = optim.opt_state_pspecs(ps, optim.OptConfig(
            compress_grads=compress))
        want = joptim.opt_state_pspecs(jps, joptim.OptConfig(
            compress_grads=compress))
        assert _tuples(got) == _tuples(want)


def test_partition_spec_is_a_tuple():
    s = P("data", None, ("pod", "data"))
    assert s == ("data", None, ("pod", "data")) and len(s) == 3
    assert repr(P("model")) == "PartitionSpec('model',)"
    ns = shd.named(make_host_mesh(1, 2, device="cpu"), {"a": P("model")})
    assert ns["a"].spec == P("model") and ns["a"].mesh.shape["model"] == 2


@pytest.mark.parametrize("n,k,want", [
    (8, 4, [(0, 2), (2, 4), (4, 6), (6, 8)]),
    (5, 4, [(0, 2), (2, 4), (4, 5), (5, 5)]),      # last block empty
    (2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),
    (3, 1, [(0, 3)])])
def test_shard_bounds_ceil_blocks(n, k, want):
    assert [shd.shard_bounds(n, k, i) for i in range(k)] == want


@pytest.mark.parametrize("spec", [
    P("data", "model"), P("model", None, "data"), P(None, ("data", "model")),
    P(("model", "data")), P(), P(None, None, "model")])
@pytest.mark.parametrize("shape", [(8, 12, 6), (5, 3, 7), (1, 2, 3)],
                         ids=["even", "uneven", "smaller-than-mesh"])
def test_shard_then_gather_is_identity(spec, shape):
    mesh = make_host_mesh(2, 3, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape)
                         .astype(np.float32))
    st = shd.put(x, shd.NamedSharding(mesh, spec))
    assert set(st.shards) == set(mesh.positions())
    assert torch.equal(shd.gather(st, "cpu"), x)
    # every element once over the distinct blocks
    assert sum(t.numel() for _, t in st.canonical()) == x.numel()
    # a position holds exactly its slices, as its own copy
    for c, t in st.shards.items():
        assert torch.equal(t, x[shd.local_slices(st.sharding, x.shape, c)])
        assert t.data_ptr() != x.data_ptr() or t.numel() == 0
    z = shd.zeros(shape, torch.float32, st.sharding)
    assert all(z.shards[c].shape == t.shape for c, t in st.shards.items())


def test_spec_must_fit_the_mesh():
    mesh = make_host_mesh(2, 2, device="cpu")
    x = torch.zeros(4, 4)
    for bad in (P("stage"), P("data", "data"), P(None, None, "model")):
        with pytest.raises(ValueError):
            shd.put(x, shd.NamedSharding(mesh, bad))


def test_sharded_tree_bytes_split_by_position():
    """qwen3's smoke tree on a (2, 2) mesh: each position holds between a
    quarter and a third (the norm scales whole, the embedding table's
    "vocab_in" rows on every model shard)."""
    m = get("qwen3-1.7b").make_smoke()
    from repro_torch.models.params import init_params
    p = init_params(m.param_defs(), 0, "cpu")
    mesh = make_host_mesh(2, 2, device="cpu")
    st = shd.device_put(p, shd.named(mesh, shd.model_param_pspecs(m, mesh)))
    held = shd.bytes_per_position(st)
    total = sum(t.numel() * t.element_size() for t in optim.tree_leaves(p))
    assert sorted(held) == mesh.positions()
    assert all(total / 4 <= b < total / 3 for b in held.values()), held
    got = shd.gather_tree(st, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(p),
                                                 optim.tree_leaves(got)))


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("placed", [False, True], ids=["logical", "colids"])
def test_sharded_pack_specs_match_reference(stacked, placed):
    from repro_torch.pud.packer import pack_linear_sharded
    g = torch.Generator().manual_seed(0)
    shape = (2, 64, 512) if stacked else (64, 512)
    w = torch.randn(shape, generator=g).to(torch.bfloat16)
    st = pack_linear_sharded(w, 2, devices=["cpu", "cpu"])
    if placed:
        st = st.map_shards(lambda s: s.replace(
            col_ids=torch.zeros(s.scale.shape, dtype=torch.int32)))
    planes, scale, col_ids = st.stacked()
    ref = types.SimpleNamespace(planes=planes.numpy(), scale=scale.numpy(),
                                col_ids=None if col_ids is None
                                else col_ids.numpy(), axis="model")
    assert _tuples(shd.sharded_pack_specs(st)) == \
        _tuples(jshd.sharded_pack_specs(ref))
    moved = shd.put_sharded_pack(st)
    assert all(torch.equal(a.planes, b.planes)
               for a, b in zip(moved.shards, st.shards))
    with pytest.raises(ValueError, match="carries no mesh"):
        shd.put_sharded_pack(st.replace(devices=None))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_restore_with_shardings_from_reference_checkpoint(tmp_path, shape):
    """The reference writes params + AdamW state; the port reads them
    straight into shards on a CPU mesh: gathered, every leaf equals the
    reference's bit for bit (bf16 included), the step is replicated."""
    jm, m = j_get("qwen3-1.7b").make_smoke(), get("qwen3-1.7b").make_smoke()
    jp = j_init(jm.param_defs(), jax.random.key(3))
    jcfg, cfg = joptim.OptConfig(), optim.OptConfig()
    js = joptim.init_opt_state(jp, jcfg)
    js["mu"] = jax.tree.map(lambda x: x + 0.5, js["mu"])
    JCkpt(tmp_path, keep=2).save(4, {"params": jp, "opt": js},
                                 metadata={"note": 1})
    mesh = make_host_mesh(*shape, device="cpu")
    ps = shd.model_param_pspecs(m, mesh)
    cuts = {"params": shd.named(mesh, ps),
            "opt": shd.named(mesh, optim.opt_state_pspecs(ps, cfg))}
    from repro_torch.models.params import abstract_params
    tmpl_p = abstract_params(m.param_defs())
    tmpl = {"params": tmpl_p, "opt": optim.init_opt_state(tmpl_p, cfg)}
    tree, step, meta = CheckpointManager(tmp_path).restore(
        tmpl, shardings=cuts, verify=True)
    assert step == 4 and meta == {"note": 1}
    assert all(shd.is_sharded(x) for x in optim.tree_leaves(tree))
    want = from_numpy(jax.tree.map(np.asarray, {"params": jp, "opt": js}),
                      "cpu")
    got = shd.gather_tree(tree, "cpu")
    for a, b in zip(optim.tree_leaves(got), optim.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    steps = tree["opt"]["step"].shards
    assert len(steps) == 4 and all(int(t) == 0 for t in steps.values())
    # and written back from shards, the same bytes
    CheckpointManager(tmp_path / "again").save(4, tree)
    back, _, _ = CheckpointManager(tmp_path / "again").restore(tmpl)
    for a, b in zip(optim.tree_leaves(back), optim.tree_leaves(want)):
        assert torch.equal(a, b)


def test_meshes_of_any_rank(monkeypatch):
    from repro_torch.launch import mesh as lm
    prod = lm.make_production_mesh(device="cpu")
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    pods = lm.make_production_mesh(multi_pod=True, device="cpu")
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert len(pods.positions()) == 512 and pods.positions()[-1] == (1, 15,
                                                                     15)
    stage = lm.make_stage_mesh(3, device="cpu")
    assert stage.describe() == "(0)->cpu, (1)->cpu, (2)->cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = lm.make_mesh((2, 1, 2), ("pod", "data", "model"), device="cuda")
    assert [d.index for d in cards.flat_devices()] == [0, 1, 2, 0]
    assert cards.device((1, 0, 0)) == torch.device("cuda", 2)
    with pytest.raises(ValueError):
        lm.make_mesh((2, 2), ("stage",), device="cpu")
    with pytest.raises(ValueError):
        lm.Mesh(((torch.device("cpu"),), ()))
    assert lm.current_mesh() is None
    with lm.use_mesh(stage) as m:
        assert m is stage and lm.current_mesh() is stage
        with lm.use_mesh(prod):
            assert lm.current_mesh() is prod
        assert lm.current_mesh() is stage
    assert lm.current_mesh() is None
