"""Parity of the port's placement, placed packs and persisted formats with
the JAX package.

The same masks and requests give identical placements (every map and
accounting array), the same weights pack into identical placed bit-words,
and placement npz files and ``fleet-calib-v2`` table entries written by one
package load in the other under the same ``table_key``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.pud import placement as jpl  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.packer import pack_model as j_pack_model  # noqa: E402
from repro.pud.packer import packing_requests as j_requests  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro.runtime import calib_cache as jcc  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.pud import placement as pl  # noqa: E402
from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,  # noqa: E402
                                  PUDGemvConfig)
from repro_torch.pud.packer import pack_model, packing_requests  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402
from repro_torch.runtime import calib_cache as cc  # noqa: E402

REQS = [("layers_0_dense/mixer/wi", 300, 3), ("layers_0_dense/mixer/wo", 96, 3),
        ("unembed/w", 1000, 0), ("forced", 512, 2, 128)]


def _masks(seed, g=6, c=1024, p=0.05):
    rng = np.random.default_rng(seed)
    return rng.random((g, c)) < p, rng.standard_normal((g, c)) * 0.03


def _assert_same(a, b):
    assert list(a.entries) == list(b.entries)
    assert tuple(a.grid_shape) == tuple(b.grid_shape)
    assert a.n_cols_per_subarray == b.n_cols_per_subarray
    assert a.avoid_faulty == b.avoid_faulty
    np.testing.assert_array_equal(a.used_per_subarray, b.used_per_subarray)
    np.testing.assert_array_equal(a.usable_per_subarray,
                                  b.usable_per_subarray)
    for name in a.entries:
        ta, tb = a.entries[name], b.entries[name]
        assert (ta.block_cols, ta.window_block) == (tb.block_cols,
                                                    tb.window_block)
        for f in ("phys_cols", "block_starts", "faulty", "stuck",
                  "local_cols"):
            np.testing.assert_array_equal(np.asarray(getattr(ta, f)),
                                          np.asarray(getattr(tb, f)))


@pytest.mark.parametrize("avoid_faulty", [True, False])
@pytest.mark.parametrize("with_offsets", [True, False])
def test_identical_placements_from_identical_masks(avoid_faulty,
                                                   with_offsets):
    masks, offs = _masks(1)
    kw = dict(avoid_faulty=avoid_faulty,
              sense_offsets=offs if with_offsets else None)
    port = pl.plan_for_grid(masks, [pl.PlacementRequest(*r) for r in REQS],
                            (1, 2, 3), **kw)
    ref = jpl.plan_for_grid(masks, [jpl.PlacementRequest(*r) for r in REQS],
                            (1, 2, 3), **kw)
    _assert_same(port, ref)
    assert port.capacity_report() == ref.capacity_report()


def test_requests_fingerprint_and_capacity_error_match():
    reqs = [pl.PlacementRequest(*r) for r in REQS]
    assert pl.requests_fingerprint(reqs) == jpl.requests_fingerprint(
        [jpl.PlacementRequest(*r) for r in REQS])
    masks, _ = _masks(2, g=1, c=512)
    with pytest.raises(pl.PlacementError):
        pl.plan_placement(masks, reqs)


def test_placement_npz_crosses_both_ways(tmp_path):
    masks, offs = _masks(3)
    port = pl.plan_placement(masks, [pl.PlacementRequest(*r) for r in REQS],
                             sense_offsets=offs)
    ref = jpl.plan_placement(masks, [jpl.PlacementRequest(*r) for r in REQS],
                             sense_offsets=offs)
    pl.save_placement_npz(tmp_path / "port.npz", port)
    jpl.save_placement_npz(tmp_path / "ref.npz", ref)
    _assert_same(jpl.load_placement_npz(tmp_path / "port.npz"), ref)
    _assert_same(pl.load_placement_npz(tmp_path / "ref.npz"), port)
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert pl.load_placement_npz(tmp_path / "bad.npz") is None


def test_calibration_table_crosses_both_ways(tmp_path):
    cfg = FleetConfig(n_channels=1, n_banks=2, n_subarrays=3, n_cols=1024)
    jcfg = JFleet(n_channels=1, n_banks=2, n_subarrays=3, n_cols=1024)
    p, jp = PhysicsParams(), JPhys()
    assert cc.table_key(cfg, p) == jcc.table_key(jcfg, jp)
    masks, offs = _masks(4)
    rng = np.random.default_rng(4)
    levels = rng.integers(0, 8, masks.shape, dtype=np.int32)
    ecr = masks.mean(axis=1).astype(np.float32)
    placement = pl.plan_placement(masks, [pl.PlacementRequest(*r)
                                          for r in REQS])

    port_cache = cc.CalibrationTableCache(tmp_path / "port")
    port_cache.save("dimm0", cfg, p, levels, ecr=ecr, masks=masks,
                    metadata={"method": "fused"})
    port_cache.save_placement("dimm0", cfg, p, "plan", placement)
    jt = jcc.CalibrationTableCache(tmp_path / "port").load(
        "dimm0", jcfg, jp, verify=True)
    np.testing.assert_array_equal(jt.levels, levels)
    np.testing.assert_array_equal(jt.masks, masks)
    np.testing.assert_array_equal(jt.ecr, ecr)
    assert jt.metadata == {"method": "fused"}
    _assert_same(jcc.CalibrationTableCache(tmp_path / "port").load_placement(
        "dimm0", jcfg, jp, "plan"), placement)

    ref_cache = jcc.CalibrationTableCache(tmp_path / "ref")
    ref_cache.save("dimm0", jcfg, jp, levels, ecr=ecr, masks=masks)
    ref_cache.save_placement("dimm0", jcfg, jp, "plan", placement)
    got = cc.CalibrationTableCache(tmp_path / "ref")
    t = got.load("dimm0", cfg, p, verify=True)
    np.testing.assert_array_equal(t.levels, levels)
    np.testing.assert_array_equal(t.masks, masks)
    _assert_same(got.load_placement("dimm0", cfg, p, "plan"), placement)
    assert got.placements("dimm0", cfg, p) == ["plan"]
    # another physics fingerprint or grid is a miss
    assert got.load("dimm0", cfg, PhysicsParams(sigma_static=0.03)) is None
    assert got.load("dimm0", FleetConfig(n_cols=1024), p) is None


@pytest.mark.parametrize("attn", [False, True])
def test_placed_pack_matches_reference(attn):
    """The same weights and placement pack into identical placed words,
    scales and col_ids, and the same requests in the same order (FFN and,
    with attention packing, the head-flattened wq)."""
    rng = np.random.default_rng(5)
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
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    packable = FFN_PACKABLE + (ATTN_PACKABLE if attn else ())
    cfg = PUDGemvConfig(packable=packable)
    jcfg = JGemvCfg(backend="reference", packable=packable)
    reqs = packing_requests(params, cfg)
    jreqs = j_requests(jparams, jcfg)
    assert [(r.name, r.n_cols, r.n_slices) for r in reqs] == \
        [(r.name, r.n_cols, r.n_slices) for r in jreqs]
    masks, offs = _masks(6, g=4, c=512)
    placement = jpl.plan_placement(masks, jreqs)
    port_pl = pl.plan_placement(masks, reqs)
    port = pack_model(params, cfg, placement=port_pl)
    ref = j_pack_model(jparams, jcfg, placement=placement)
    assert port.packed_names == ref.packed_names
    for name, pt in port.tensors.items():
        jt = ref.tensor(name)
        for f in ("planes", "scale", "col_ids"):
            np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                          np.asarray(getattr(jt, f)))
        assert (pt.layout, pt.logical_k, pt.window_block) == \
            (jt.layout, jt.logical_k, jt.window_block)
    assert "wi" not in port.params["layers_0_dense"]["mixer"]
    assert "w" in params["unembed"]            # the input tree is untouched
