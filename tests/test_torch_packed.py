"""Parity of the port's pack surface with the JAX package's: the
``pud-pack-v2`` archive read both ways, layout conversions, the N-axis word
packing kept for the format comparison, the GEMV oracles and
``PhysicsParams.frac_charge``.

Integer results (planes, col_ids, accumulators, levels) are held exactly
equal.  The float32 oracle outputs are held to rtol 1e-6: both packages
dequantize with the same float32 operations in the same order, but the
float32 matmul of ``pud_linear_ref`` may sum in another order (the sums
are integers far below 2^24, so they are exact, and only the final scale
products can differ by rounding).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.pud import packed as jpk  # noqa: E402
from repro.pud import placement as jpl  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.gemv import pud_linear_ref as j_linear_ref  # noqa: E402
from repro.pud.packer import pack_model as j_pack_model  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.pud import packed as pk  # noqa: E402
from repro_torch.pud import placement as pl  # noqa: E402
from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,  # noqa: E402
                                  PUDGemvConfig, pack_linear, pud_linear,
                                  pud_linear_ref)
from repro_torch.pud.packer import (pack_for_serving, pack_model,  # noqa: E402
                                    packing_requests)
from repro_torch.pud.physics import PhysicsParams  # noqa: E402

PACKABLE = FFN_PACKABLE + ATTN_PACKABLE


def _trees(seed=5):
    """One parameter tree in both packages: stacked FFN and attention
    weights (K 64 and 300: byte padding and a ragged window) and an
    unembed."""
    rng = np.random.default_rng(seed)
    bf16 = jnp.bfloat16
    jparams = {
        "layers_0_dense": {"mixer": {
            "wi": jnp.asarray(rng.standard_normal((2, 64, 300)), bf16),
            "wo": jnp.asarray(rng.standard_normal((2, 300, 64)), bf16)},
            "attn": {"wq": jnp.asarray(rng.standard_normal((2, 64, 4, 16)),
                                       bf16)}},
        "unembed": {"w": jnp.asarray(rng.standard_normal((64, 500)), bf16)},
    }
    jparams = jax.tree.map(lambda a: a, jparams)     # pytree (sorted) order
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _models(placed: bool):
    jparams, params = _trees()
    cfg, jcfg = (PUDGemvConfig(packable=PACKABLE),
                 JGemvCfg(backend="reference", packable=PACKABLE))
    placement = None
    if placed:
        masks = np.random.default_rng(6).random((4, 512)) < 0.05
        placement = pl.plan_placement(masks, packing_requests(params, cfg))
    jplace = None
    if placed:
        jplace = jpl.plan_placement(masks, [
            jpl.PlacementRequest(r.name, r.n_cols, r.n_slices)
            for r in packing_requests(params, cfg)])
    return (pack_model(params, cfg, placement=placement),
            j_pack_model(jparams, jcfg, placement=jplace))


def _assert_same_pack(pt, jt):
    for f in ("planes", "scale", "col_ids"):
        a, b = getattr(pt, f), getattr(jt, f)
        if b is None:
            assert a is None, f
            continue
        a = a.numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
    assert (pt.layout, pt.logical_k, pt.window_block) == \
        (jt.layout, jt.logical_k, jt.window_block)


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "unplaced"])
def test_archives_cross_both_ways(tmp_path, placed):
    """Placed and unplaced models with stacked [L, WB, Kw, N] packs: each
    package's archive loads in the other, bit for bit."""
    port, jm = _models(placed)
    assert port.placed == jm.placed == placed
    assert list(port.tensors) == list(jm.tensors)
    pk.save_packed_npz(tmp_path / "port.npz", port)
    jpk.save_packed_npz(tmp_path / "ref.npz", jm)
    from_port = jpk.load_packed_npz(tmp_path / "port.npz")
    from_ref = pk.load_packed_npz(tmp_path / "ref.npz", device="cpu")
    assert list(from_port) == list(from_ref) == list(port.tensors)
    for name, pt in port.tensors.items():
        _assert_same_pack(pt, jm.tensor(name))        # the same packs ...
        _assert_same_pack(from_ref[name], jm.tensor(name))
        _assert_same_pack(pt, from_port[name])         # ... both ways
        assert from_ref[name].backend == "reference"
        assert from_port[name].tile_plan is None
    assert any(pt.planes.dim() == 4 for pt in port.tensors.values())
    own = pk.load_packed_npz(tmp_path / "port.npz", device="cpu")
    for name, pt in port.tensors.items():
        _assert_same_pack(own[name], pt)
    meta = json.loads(str(np.load(tmp_path / "port.npz")["meta"]))
    assert meta["format"] == pk.PACK_FORMAT == jpk.PACK_FORMAT
    assert meta["placed"] == placed and meta["weight_bits"] == 4


def test_v1_archive_loads_by_dtype(tmp_path):
    """A dense-era ``pud-pack-v1`` archive (no per-entry metadata): dense
    int8 planes stay dense, uint8 planes read as bit-packed words."""
    rng = np.random.default_rng(1)
    dense = rng.integers(0, 2, (4, 24, 40), dtype=np.int8)
    words = np.asarray(jref.pack_plane_words(jnp.asarray(dense)))
    scale = rng.random(40).astype(np.float32)
    ids = rng.permutation(48)[:40].astype(np.int32)
    meta = {"format": "pud-pack-v1", "names": ["a/w", "b/w"]}
    np.savez(tmp_path / "v1.npz", meta=np.array(json.dumps(meta)),
             t0_planes=dense, t0_scale=scale,
             t1_planes=words, t1_scale=scale, t1_col_ids=ids)
    got = pk.load_packed_npz(tmp_path / "v1.npz", device="cpu")
    want = jpk.load_packed_npz(tmp_path / "v1.npz")
    for name in ("a/w", "b/w"):
        _assert_same_pack(got[name], want[name])
    assert got["a/w"].layout == "dense" and not got["a/w"].placed
    assert got["b/w"].layout == "bitpack8" and got["b/w"].placed
    assert got["b/w"].k == 24 == want["b/w"].k


def test_corrupt_and_unknown_archives_read_as_none(tmp_path):
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert pk.load_packed_npz(tmp_path / "bad.npz", device="cpu") is None
    assert pk.load_packed_npz(tmp_path / "missing.npz", device="cpu") is None
    np.savez(tmp_path / "v9.npz", meta=np.array(json.dumps(
        {"format": "pud-pack-v9", "names": []})))
    assert pk.load_packed_npz(tmp_path / "v9.npz", device="cpu") is None
    np.savez(tmp_path / "short.npz", meta=np.array(json.dumps(
        {"format": pk.PACK_FORMAT, "names": ["x"]})))
    assert pk.load_packed_npz(tmp_path / "short.npz", device="cpu") is None
    # an archive the reference made for a backend the port lacks
    port, _ = _models(False)
    pk.save_packed_npz(tmp_path / "p.npz", port)
    z = dict(np.load(tmp_path / "p.npz"))
    meta = json.loads(str(z["meta"]))
    for e in meta["entries"].values():
        e["backend"] = "pallas"
    z["meta"] = np.array(json.dumps(meta))
    np.savez(tmp_path / "pallas.npz", **z)
    got = pk.load_packed_npz(tmp_path / "pallas.npz", device="cpu")
    assert all(pt.backend is None for pt in got.values())


def test_load_needs_a_device(tmp_path):
    port, _ = _models(False)
    pk.save_packed_npz(tmp_path / "p.npz", port)
    if torch.cuda.is_available():
        got = pk.load_packed_npz(tmp_path / "p.npz")
        assert all(pt.planes.is_cuda for pt in got.values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pk.load_packed_npz(tmp_path / "p.npz")


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "unplaced"])
def test_layout_round_trips_equal_reference(placed):
    port, jm = _models(placed)
    for name, pt in port.tensors.items():
        jt = jm.tensor(name)
        dense, jdense = pk.to_dense(pt), jpk.to_dense(jt)
        _assert_same_pack(dense, jdense)
        assert dense.k == pt.k and dense.n_bits == pt.n_bits == 4
        back, jback = pk.to_bitpacked(dense), jpk.to_bitpacked(jdense)
        _assert_same_pack(back, jback)
        assert torch.equal(back.planes[..., : pt.planes.shape[-2], :],
                           pt.planes)
        assert pk.to_dense(dense) is dense and pk.to_bitpacked(pt) is pt


def test_typed_pack_views_and_mappings():
    port, jm = _models(True)
    pt = port.tensor("unembed/w")
    jt = jm.tensor("unembed/w")
    assert pt.placed and pt.bitpacked and pt.n_bits == 4
    assert pt.keys() == jt.keys() == ("planes", "scale", "col_ids")
    assert [k for k, _ in pt.items()] == [k for k, _ in jt.items()]
    assert pt.get("col_ids") is pt.col_ids and pt.get("nope", 3) == 3
    unplaced = pt.replace(col_ids=None)
    assert not unplaced.placed and unplaced.get("col_ids", 0) == 0
    assert unplaced.keys() == ("planes", "scale")
    assert pk.is_pack(pt) and not pk.is_pack(pt.planes)
    mapping = {"planes": pt.planes, "scale": pt.scale}
    assert pk.is_pack(mapping) and not pk.is_pack({"planes": pt.planes})
    coerced = pk.as_packed_tensor(mapping)
    jc = jpk.as_packed_tensor({"planes": jt.planes, "scale": jt.scale})
    assert coerced.layout == jc.layout == "bitpack8"
    assert coerced.k == jc.k and pk.as_packed_tensor(pt) is pt
    dense = pk.to_dense(pt)
    assert pk.as_packed_tensor(dict(dense.items())).layout == "dense"


@pytest.mark.parametrize("k, n", [(24, 64), (16, 45), (8, 1)])
def test_n_axis_words_round_trip_and_equal_reference(k, n):
    planes = np.random.default_rng(k + n).integers(0, 2, (3, k, n),
                                                   dtype=np.int8)
    words = ref.pack_plane_words_n(torch.from_numpy(planes))
    want = np.asarray(jref.pack_plane_words_n(jnp.asarray(planes)))
    assert words.dtype == torch.uint32 and words.shape == want.shape
    np.testing.assert_array_equal(words.numpy(), want)
    back = ref.unpack_plane_words_n(words, n)
    np.testing.assert_array_equal(back.numpy(), planes)
    np.testing.assert_array_equal(
        ref.unpack_plane_words_n(words).numpy(),
        np.asarray(jref.unpack_plane_words_n(jnp.asarray(want))))


@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("b", [1, 3])
def test_pud_gemv_ref_equals_reference(placed, b):
    rng = np.random.default_rng(b + placed)
    k, n, wb = 96, 80, 4
    w = rng.integers(-8, 8, (k, n)).astype(np.int32)
    planes = ref.pack_bitplanes(torch.from_numpy(w), wb)
    col_ids = None
    if placed:
        ids = rng.permutation(112)[:n].astype(np.int32)
        window = torch.zeros((wb, k, 112), dtype=torch.int8)
        window[:, :, torch.from_numpy(ids).long()] = planes
        planes, col_ids = window, torch.from_numpy(ids)
    x = rng.standard_normal((b, k)).astype(np.float32)
    scale = (rng.random(n) + 0.05).astype(np.float32)
    got = ops.pud_gemv_ref(torch.from_numpy(x), planes,
                           torch.from_numpy(scale), col_ids)
    want = jops.pud_gemv_ref(
        jnp.asarray(x), jnp.asarray(planes.numpy()), jnp.asarray(scale),
        None if col_ids is None else jnp.asarray(col_ids.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    # the integer part is exact: the plain GEMV of the quantized rows
    xq, _ = ops.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(
        ref.bitplane_gemv_ref(xq, ref.pack_bitplanes(torch.from_numpy(w),
                                                     wb)).numpy(),
        xq.numpy().astype(np.int64) @ w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pud_linear_ref_equals_reference_and_pud_linear(dtype):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((64, 40)).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jw = jnp.asarray(w, getattr(jnp, dtype))
    got = pud_linear_ref(torch.from_numpy(x), tw)
    want = j_linear_ref(jnp.asarray(x), jw)
    assert tuple(got.shape) == (2, 3, 40)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=0)
    # the oracle of the packed path: pud_linear on the plain versions
    packed = pud_linear(torch.from_numpy(x), pack_linear(tw),
                        backend="reference")
    np.testing.assert_allclose(packed.numpy(), got.float().numpy(),
                               rtol=1e-6, atol=0)


def test_pack_for_serving_returns_the_tree_and_report():
    _, params = _trees()
    cfg = PUDGemvConfig(packable=PACKABLE)
    tree, report = pack_for_serving(params, cfg)
    pm = pack_model(params, cfg)
    assert report == pm.report
    assert report["packed"] == list(pm.packed_names) and not report["placed"]
    for name, pt in pm.tensors.items():
        node = tree
        for part in name.split("/")[:-1]:
            node = node[part]
        assert torch.equal(node[name.split("/")[-1] + "_pud"].planes,
                           pt.planes)


def test_frac_charge_matches_reference():
    bits = np.array([0, 1, 1, 0, 1], np.float32)
    n = np.array([0, 1, 2, 3, 6], np.int32)
    got = PhysicsParams().frac_charge(torch.from_numpy(bits),
                                      torch.from_numpy(n))
    want = JPhys().frac_charge(jnp.asarray(bits), jnp.asarray(n))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def _stamped(pm):
    """``pm`` with every pack stamped with tuned plans (``PUDSession.tune``
    stamps one per row class)."""
    from repro_torch.kernels.autotune import TunedPlan
    from repro_torch.runtime.session import _restamp_model
    plans = (("gemm", TunedPlan(tensor_cores=False, rows=4, stage_words=8,
                                n_split=1)),
             ("gemm_tc64", TunedPlan(tensor_cores=True, rows=64)),
             ("gemv", TunedPlan(stage_words=4)))
    return _restamp_model(pm, {n: pt.replace(tile_plan=plans)
                               for n, pt in pm.tensors.items()})


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "unplaced"])
def test_archives_keep_stamped_plans_and_the_reference_reads_them(
        tmp_path, placed):
    """A stamped archive round-trips in the port with its plans; the
    reference loads the same file with ``tile_plan`` None (its own key
    stays null; the port's plans ride under a key it ignores) and every
    pack intact."""
    port, jm = _models(placed)
    tuned = _stamped(port)
    pk.save_packed_npz(tmp_path / "tuned.npz", tuned)
    own = pk.load_packed_npz(tmp_path / "tuned.npz", device="cpu")
    from_port = jpk.load_packed_npz(tmp_path / "tuned.npz")
    assert from_port is not None and list(from_port) == list(tuned.tensors)
    for name, pt in tuned.tensors.items():
        assert own[name].tile_plan == pt.tile_plan is not None
        _assert_same_pack(own[name], pt)
        assert from_port[name].tile_plan is None
        _assert_same_pack(pt, from_port[name])
        _assert_same_pack(pt, jm.tensor(name))
    meta = json.loads(str(np.load(tmp_path / "tuned.npz")["meta"]))
    for e in meta["entries"].values():
        assert e["tile_plan"] is None and e[pk.PLAN_KEY][0][0] == "gemm"


def test_reference_tile_plans_read_as_none(tmp_path):
    """The reference's stamped ``TunedTile`` names TPU tiles: the port
    loads such an archive with ``tile_plan`` None and every pack intact;
    a corrupt port plan makes the archive a miss, as any corruption."""
    from repro.kernels.autotune import TunedTile
    port, jm = _models(True)
    stamped = {n: jt.replace(tile_plan=(("gemm", TunedTile(n_block=128)),))
               for n, jt in jm.tensors.items()}
    from repro.runtime.session import _restamp_model as j_restamp
    jtuned = j_restamp(jm, stamped)
    jpk.save_packed_npz(tmp_path / "ref.npz", jtuned)
    meta = json.loads(str(np.load(tmp_path / "ref.npz")["meta"]))
    assert all(e["tile_plan"] for e in meta["entries"].values())
    got = pk.load_packed_npz(tmp_path / "ref.npz", device="cpu")
    for name, pt in got.items():
        assert pt.tile_plan is None
        _assert_same_pack(pt, jm.tensor(name))
    pk.save_packed_npz(tmp_path / "p.npz", _stamped(port))
    z = dict(np.load(tmp_path / "p.npz"))
    meta = json.loads(str(z["meta"]))
    next(iter(meta["entries"].values()))[pk.PLAN_KEY] = [["gemm",
                                                          {"n_block": 8}]]
    z["meta"] = np.array(json.dumps(meta))
    np.savez(tmp_path / "bad.npz", **z)
    assert pk.load_packed_npz(tmp_path / "bad.npz", device="cpu") is None


def test_conversions_drop_plans_and_stacked_layers_keep_them():
    port, _ = _models(False)
    pt = _stamped(port).tensor("layers_0_dense/mixer/wi")
    assert pt.layer(1).tile_plan == pt.tile_plan is not None
    assert pk.to_dense(pt).tile_plan is None
    assert pk.to_bitpacked(pk.to_dense(pt)).tile_plan is None
