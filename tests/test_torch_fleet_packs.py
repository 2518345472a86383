"""The port's tensor-parallel packs against the JAX package: the reference's
``pack_linear_sharded`` / ``pack_model_sharded`` and the port's, from the
same bf16 weights and per-shard placements planned on the same masks.

Tolerances: none.  The stacked planes, scales (with their 1.0 pads) and
``col_ids`` equal the reference's bit for bit, and so do the split
geometry (``shard_widths``, ``block_cols``, ``window_block``); the port's
``pud_matmul_sharded`` equals the reference's unsharded ``pud_matmul``
(float outputs) and the port's unsharded one (int32 accumulators, float
outputs), exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.pud import packed as jpk  # noqa: E402
from repro.pud import packer as jpacker  # noqa: E402
from repro.pud import placement as jpl  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.gemv import pack_linear as j_pack_linear  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.models.transformer import layer_slice  # noqa: E402
from repro_torch.pud import packed as pk  # noqa: E402
from repro_torch.pud import placement as pl  # noqa: E402
from repro_torch.pud.gemv import PUDGemvConfig, pud_linear  # noqa: E402
from repro_torch.pud.packer import (pack_linear_sharded,  # noqa: E402
                                    pack_model_sharded)

CPU = torch.device("cpu")


def _weights(shape, seed):
    w = np.random.default_rng(seed).standard_normal(shape)
    jw = jnp.asarray(w, jnp.bfloat16)
    return jw, torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        torch.bfloat16)


def _placements(n, n_shards, lead, seed, name="w"):
    """Per-shard placements of one tensor's column slices, planned on each
    shard's own random masks, in both packages (None for an empty
    shard)."""
    spans, bc = pl.shard_column_slices(n, n_shards)
    ports, refs = [], []
    for m, (lo, hi) in enumerate(spans):
        if hi == lo:
            ports.append(None)
            refs.append(None)
            continue
        masks = np.random.default_rng(seed + m).random((4, 2048)) < 0.05
        req = dict(name=name, n_cols=hi - lo, n_slices=lead, block_cols=bc)
        ports.append(pl.plan_placement(masks, [pl.PlacementRequest(**req)]))
        refs.append(jpl.plan_placement(masks,
                                       [jpl.PlacementRequest(**req)]))
    return ports, refs


def _assert_same_sharded(st, jst):
    planes, scale, col_ids = st.stacked()
    for f, a in (("planes", planes), ("scale", scale),
                 ("col_ids", col_ids)):
        b = getattr(jst, f)
        if b is None:
            assert a is None, f
            continue
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and tuple(a.shape) == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert st.shard_widths == jst.shard_widths
    assert (st.block_cols, st.window_block, st.layout, st.logical_k) == \
        (jst.block_cols, jst.window_block, jst.layout, jst.logical_k)
    assert (st.n_shards, st.n, st.padded_n, st.k, st.n_bits) == \
        (jst.n_shards, jst.n, jst.padded_n, jst.k, jst.n_bits)


# N 1536: six blocks, an even split over 2 and 3 shards and remainder
# blocks to the early shards over 4; 384: no 256 divisor (192-column
# blocks), so a zero-width tail over 3 and 4; 256: one block, so every
# shard but the first is all padding
CASES = [(n, s) for n in (1536, 384, 256) for s in (1, 2, 3, 4)]


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "logical"])
@pytest.mark.parametrize("n,n_shards", CASES,
                         ids=[f"N{n}-S{s}" for n, s in CASES])
def test_sharded_pack_equals_reference(n, n_shards, placed):
    jw, w = _weights((2, 72, n), seed=n + n_shards)
    ports, refs = (_placements(n, n_shards, 2, seed=n) if placed
                   else (None, None))
    st = pack_linear_sharded(w, n_shards, n_bits=4, placements=ports,
                             name="w", devices=[CPU] * n_shards)
    jst = jpacker.pack_linear_sharded(jw, n_shards, n_bits=4,
                                      placements=refs, name="w",
                                      backend="reference")
    _assert_same_sharded(st, jst)
    assert st.placed == placed
    widths = st.shard_widths
    assert sum(widths) == n and all(w_ % st.block_cols == 0 for w_ in widths)
    if 0 in widths:                       # an all-padding tail shard
        tail = st.shards[widths.index(0)]
        assert bool((tail.planes == 0).all()) and bool((tail.scale == 1).all())


@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("placed", [True, False], ids=["placed", "logical"])
def test_2d_8bit_and_dense_layouts_equal_reference(placed, n_bits):
    """An unstacked [K, N] tensor at 4 and 8 bits over 3 shards, then the
    dense layout of the same packs (``to_dense``) and back."""
    jw, w = _weights((300, 1536), seed=3)
    ports, refs = (_placements(1536, 3, 0, seed=9) if placed
                   else (None, None))
    st = pack_linear_sharded(w, 3, n_bits=n_bits, placements=ports,
                             name="w", devices=[CPU] * 3)
    jst = jpacker.pack_linear_sharded(jw, 3, n_bits=n_bits,
                                      placements=refs, name="w")
    _assert_same_sharded(st, jst)
    dense, jdense = pk.to_dense(st), jpk.to_dense(jst)
    assert dense.layout == pk.LAYOUT_DENSE and dense.logical_k is None
    _assert_same_sharded(dense, jdense)
    back = pk.to_bitpacked(dense)
    for a, b in zip(back.shards, st.shards):
        assert torch.equal(a.planes, b.planes)


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "logical"])
@pytest.mark.parametrize("b", [1, 5])
def test_sharded_matmul_equals_unsharded(placed, b):
    """``pud_matmul_sharded`` (and ``pud_linear`` on a sharded pack) ==
    the reference's and the port's unsharded ``pud_matmul`` over the
    unsharded pack of the same weights."""
    jw, w = _weights((300, 1536), seed=4)
    ports = _placements(1536, 4, 0, seed=2)[0] if placed else None
    st = pack_linear_sharded(w, 4, n_bits=4, placements=ports, name="w",
                             devices=[CPU] * 4)
    x = np.random.default_rng(b).standard_normal((b, 300)).astype(
        np.float32)
    got = ops.pud_matmul_sharded(torch.from_numpy(x), st)
    jpt = j_pack_linear(jw, 4, backend="reference")
    want = jops.pud_matmul(jnp.asarray(x), jpt.planes, jpt.scale,
                           backend="reference", layout=jpt.layout,
                           logical_k=jpt.logical_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    from repro_torch.pud.gemv import pack_linear
    pt = pack_linear(w, 4)
    port = ops.pud_matmul(torch.from_numpy(x), pt.planes, pt.scale,
                          layout=pt.layout, logical_k=pt.logical_k)
    assert torch.equal(got, port)
    assert torch.equal(pud_linear(torch.from_numpy(x), st), got)
    # the int32 accumulators: each live shard's, cut to its width and
    # concatenated, == the unsharded GEMM's
    xq, _ = ops.quantize_activations(torch.from_numpy(x))
    acc = []
    for shard, width in zip(st.shards, st.shard_widths):
        if not width:
            continue
        dense = pk.to_dense(shard).planes
        part = (ref.bitplane_gemv_placed_ref(xq, dense, shard.col_ids)
                if placed else ref.bitplane_gemv_ref(xq, dense))
        acc.append(part[:, :width])
    want_acc = ref.bitplane_gemv_ref(xq, pk.to_dense(pt).planes)
    assert torch.equal(torch.cat(acc, dim=-1), want_acc)


def test_pack_without_devices_does_not_execute():
    _, w = _weights((64, 512), seed=1)
    st = pack_linear_sharded(w, 2)
    assert st.devices is None
    with pytest.raises(ValueError, match="carries no devices"):
        ops.pud_matmul_sharded(torch.zeros((1, 64)), st)


def _tree(seed=5):
    rng = np.random.default_rng(seed)
    bf16 = jnp.bfloat16
    jparams = {
        "layers_0_dense": {"mixer": {
            "wi": jnp.asarray(rng.standard_normal((2, 64, 600)), bf16),
            "wo": jnp.asarray(rng.standard_normal((2, 600, 64)), bf16)}},
        "unembed": {"w": jnp.asarray(rng.standard_normal((64, 1024)),
                                     bf16)},
    }
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def test_model_pack_layer_slices_bytes_and_archive(tmp_path):
    """``pack_model_sharded`` over a tree: every pack equals the
    reference's; a layer slice keeps the shard axis (``[L, S, ...]`` ->
    ``[S, ...]``); ``packed_bytes`` and the archive read it as the
    reference's do."""
    jparams, params = _tree()
    cfg = PUDGemvConfig(weight_bits=4)
    pm = pack_model_sharded(params, cfg, n_shards=3, devices=[CPU] * 3)
    jpm = jpacker.pack_model_sharded(jparams, JGemvCfg(backend="reference"),
                                     n_shards=3)
    assert pm.packed_names == jpm.packed_names
    for name in pm.packed_names:
        _assert_same_sharded(pm.tensor(name), jpm.tensor(name))
    wi = pm.tensor("layers_0_dense/mixer/wi")
    one = layer_slice(pm.params["layers_0_dense"], 1)["mixer"]["wi_pud"]
    assert isinstance(one, pk.ShardedPackedTensor) and one.n_shards == 3
    jwi = jpm.tensor("layers_0_dense/mixer/wi")
    np.testing.assert_array_equal(one.stacked()[0].numpy(),
                                  np.asarray(jwi.planes[1]))
    assert pk.as_packed_tensor(wi) is wi and pk.is_pack(wi)
    # the reference's packed_bytes reads no sharded pack's dense
    # equivalent; its stored bytes are the stacked children's
    got = pk.packed_bytes(pm)
    assert got["stored_bytes"] == sum(jpm.tensor(n).stored_bytes
                                      for n in jpm.packed_names)
    assert got["dense_equiv_bytes"] == sum(
        pk.to_dense(pm.tensor(n)).stored_bytes for n in pm.packed_names)
    pk.save_packed_npz(tmp_path / "port.npz", pm)
    jpk.save_packed_npz(tmp_path / "ref.npz", jpm)
    for path in ("port.npz", "ref.npz"):
        loaded = jpk.load_packed_npz(tmp_path / path)
        for name in pm.packed_names:
            np.testing.assert_array_equal(np.asarray(loaded[name].planes),
                                          np.asarray(jpm.tensor(name).planes))
    mine = pk.load_packed_npz(tmp_path / "ref.npz", device="cpu")
    assert torch.equal(mine["unembed/w"].planes,
                       pm.tensor("unembed/w").stacked()[0])
