"""Parity of the port's unplaced bit-plane GEMM/GEMV (plain versions on the
CPU) with the JAX package's ``bitplane_gemm`` / ``bitplane_gemv``.

Integer results are exact: the port's entries equal the reference's Pallas
kernels (interpret mode, bit-packed words) and the integer product
x @ (W - 2^(WB-1)) over ragged batches, a K that is not a multiple of 8, an
N that is not a multiple of 128, both execution modes and both plane
layouts.  ``pud_matmul`` on an unplaced pack is bit-equal to the
reference's for float32 activations.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitplane_gemm import bitplane_gemm  # noqa: E402
from repro.kernels.bitplane_gemv import bitplane_gemv  # noqa: E402
from repro.kernels.ops import pud_matmul as j_pud_matmul  # noqa: E402
from repro_torch.kernels import backends, plane_gemm, ref  # noqa: E402
from repro_torch.kernels.ops import pud_matmul  # noqa: E402

N, WB = 200, 4


def _pack(seed, k):
    """Signed 4-bit weights [K, N], their dense planes and bit-words."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-8, 8, (k, N), dtype=np.int32)
    planes = np.array(jref.pack_bitplanes(jnp.asarray(w), WB))
    words = np.array(jref.pack_plane_words(jnp.asarray(planes)))
    return w, planes, words


def _x(seed, b, k):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(-127, 128, (b, k), dtype=np.int64).astype(np.int8)


def test_port_packs_equal_reference_packs():
    w, planes, words = _pack(0, 100)
    tp = ref.pack_bitplanes(torch.from_numpy(w), WB)
    np.testing.assert_array_equal(tp.numpy(), planes)
    np.testing.assert_array_equal(ref.pack_plane_words(tp).numpy(), words)


@pytest.mark.parametrize("mode", ["planes", "folded"])
@pytest.mark.parametrize("k", [64, 100])
@pytest.mark.parametrize("b", [1, 3, 8, 33])
def test_unplaced_entries_match_reference(b, k, mode):
    w, planes, words = _pack(b * 10 + k, k)
    x = _x(k, b, k)
    want = x.astype(np.int64) @ (w.astype(np.int64))
    jx, jw = jnp.asarray(x), jnp.asarray(words)
    kw = dict(mode=mode, interpret=True, layout="bitpack8", logical_k=k)
    np.testing.assert_array_equal(np.asarray(bitplane_gemm(jx, jw, **kw)),
                                  want)
    np.testing.assert_array_equal(np.asarray(bitplane_gemv(jx, jw, **kw)),
                                  want)
    tx, tw = torch.from_numpy(x), torch.from_numpy(words)
    got = plane_gemm.gemm(tx, tw, mode, layout="bitpack8", logical_k=k)
    assert got.dtype == torch.int32 and got.shape == (b, N)
    np.testing.assert_array_equal(got.numpy(), want)
    if b == 1:
        np.testing.assert_array_equal(
            plane_gemm.gemv(tx, tw, mode, layout="bitpack8",
                            logical_k=k).numpy(), want)
    dense = plane_gemm.gemm_plain(tx, torch.from_numpy(planes), mode,
                                  layout="dense")
    np.testing.assert_array_equal(dense.numpy(), want)
    # the cuda backend on CPU tensors runs the same plain versions
    be = backends.get_backend("cuda")
    entry = be.gemv if b == 1 else be.gemm
    np.testing.assert_array_equal(
        entry(tx, tw, mode, layout="bitpack8", logical_k=k).numpy(), want)


def test_entries_reject_bad_mode_and_layout():
    _, _, words = _pack(1, 64)
    tx = torch.from_numpy(_x(1, 2, 64))
    with pytest.raises(ValueError, match="mode"):
        plane_gemm.gemm(tx, torch.from_numpy(words), "bitwise",
                        layout="bitpack8", logical_k=64)
    with pytest.raises(ValueError, match="layout"):
        plane_gemm.gemm(tx, torch.from_numpy(words), layout="nibble")


@pytest.mark.parametrize("b", [1, 4])
def test_pud_matmul_unplaced_matches_reference(b):
    w, planes, words = _pack(3, 100)
    rng = np.random.default_rng(b)
    x = rng.standard_normal((b, 100)).astype(np.float32)
    scale = (rng.random(N) + 0.01).astype(np.float32)
    want = np.asarray(j_pud_matmul(
        jnp.asarray(x), jnp.asarray(words), jnp.asarray(scale),
        mode="folded", backend="reference", layout="bitpack8",
        logical_k=100))
    for backend in ("reference", "cuda"):
        got = pud_matmul(torch.from_numpy(x), torch.from_numpy(words),
                         torch.from_numpy(scale), backend=backend,
                         layout="bitpack8", logical_k=100)
        np.testing.assert_array_equal(got.numpy(), want)


# ---- the launch plan (kernels/plane_gemm.plan_launch) and a plain
# emulation of the tensor-core schedule, checked without a GPU.

# Main-path shapes of qwen3-1.7b (wi/wg, wo, unembed, the dense benchmark
# pack) and ragged ones: (K, N).
PLAN_KN = [(2048, 6144), (6144, 2048), (2048, 151936), (2048, 2048),
           (100, 77), (100, 200), (2048, 77), (6144, 200)]
PLAN_B = [1, 4, 16, 17, 64, 128, 129]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("kn", PLAN_KN)
@pytest.mark.parametrize("b", PLAN_B)
def test_plane_plan_covers_its_operands(b, kn, dense):
    """grid x tile x split covers [B, N, Kw] exactly once: column tiles
    cover N, row tiles cover B, K splits cover every word once in whole
    stages; the stage layout adds up and fits one block's shared memory."""
    k, n = kn
    kw = -(-k // 8)
    p = plane_gemm.plan_launch(b, kw, n, WB, dense)
    assert p.tensor_cores == (b >= 17)
    gx, gy, gz = p.grid
    assert (gx - 1) * plane_gemm.TILE_COLS < n <= gx * plane_gemm.TILE_COLS
    assert (gy - 1) * p.rows < b <= gy * p.rows
    assert gz == p.n_split
    assert p.split_words % p.stage_words == 0
    spans = [(z * p.split_words, min(kw, (z + 1) * p.split_words))
             for z in range(p.n_split)]
    assert spans[0][0] == 0 and spans[-1][1] == kw
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    if p.tensor_cores:
        assert p.rows in plane_gemm.TC_ROWS and p.rows >= min(b, 64)
        assert p.stage_words in plane_gemm.STAGE_WORDS
        assert p.stages == plane_gemm.STAGES
        assert p.x_row == 8 * p.stage_words + plane_gemm.PAD
        assert p.x_row % 16 == 0
        assert p.w_stage == WB * (8 if dense else 1) * p.stage_words * 128
        assert p.stage_bytes == p.w_stage + p.rows * p.x_row
        wt = 2 * p.stage_words * plane_gemm.WT_STRIDE * 4
        assert p.stages * p.stage_bytes + wt <= p.smem_bytes \
            <= plane_gemm.SMEM_MAX
    else:
        assert p.rows in plane_gemm.DP4A_ROWS and p.rows >= b
        assert p.stage_words == plane_gemm.CHUNK_WORDS


def _c_rule(b, kw, n, sms, gemv):
    """The dp4a launch rule the C side applied before the plan moved to
    the host: tiles of 1 (GEMV), 4 (B <= 4) or 16 rows and 128 columns;
    K split in chunks of 64 words until about two blocks per SM."""
    bt = 1 if gemv else (4 if b <= 4 else 16)
    tiles_n = (n + 127) // 128
    tiles_b = (b + bt - 1) // bt
    chunks = (kw + 63) // 64
    tiles = tiles_n * tiles_b
    want = (2 * sms + tiles - 1) // tiles
    split = want if want < chunks else chunks
    split = 1 if split < 1 else split
    split_words = ((chunks + split - 1) // split) * 64
    n_split = (kw + split_words - 1) // split_words
    return bt, split_words, n_split, (tiles_n, tiles_b, n_split)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("kn", PLAN_KN)
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 15, 16])
def test_decode_plan_reproduces_the_c_rule(b, kn, dense):
    """At 132 SMs, B <= 16 keeps the rule the C side used: the same rows
    per block (B = 1 as the GEMV entry ran it: the GEMM entry's 4-row tile
    at B = 1 becomes the one-row tile, the same grid), K split and grid."""
    k, n = kn
    kw = -(-k // 8)
    p = plane_gemm.plan_launch(b, kw, n, WB, dense, 132)
    bt, split_words, n_split, grid = _c_rule(b, kw, n, 132, b == 1)
    assert not p.tensor_cores
    assert (p.rows, p.split_words, p.n_split, p.grid) == \
        (bt, split_words, n_split, grid)
    if b == 1:     # the GEMM entry's old 4-row tile: the same grid
        assert _c_rule(1, kw, n, 132, False)[1:] == (split_words, n_split,
                                                     grid)


@pytest.mark.parametrize("kn", [(2048, 6144), (6144, 2048)])
def test_prefill_plan_fills_the_card(kn):
    """x [128, 2048] x wi and x [128, 6144] x wo on tensor cores put about
    two blocks per SM in flight at 132 SMs (more made the placed
    tensor-core path slower), and fewer SMs get fewer K splits."""
    k, n = kn
    p = plane_gemm.plan_launch(128, k // 8, n, WB, False, 132)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    assert p.tensor_cores and p.rows == 128
    assert 1.9 * 132 <= blocks < 3 * 132
    # fewer SMs, fewer splits: the SM count is part of the plan
    few = plane_gemm.plan_launch(128, k // 8, n, WB, False, 16)
    assert few.n_split < p.n_split


def _spread4(nib):
    return (nib * 0x00204081) & 0x01010101


def _emulate_tc(x, planes, layout, logical_k, sms):
    """The tensor-core schedule in plain PyTorch: per block (128 columns,
    ``rows`` x rows, one K split) and stage, the staged weight rows and x
    rows zero-filled as the kernel fills them, the dense rows folded into
    words, each word rebuilt into signed int8 by the kernel's spread /
    per-byte subtract, the [8 KC, 128] int8 tile multiplied with the x
    stage in int64, and the blocks' partial sums added."""
    dense = layout == "dense"
    b, k = x.shape
    wb, rpp, n = planes.shape
    kw = -(-k // 8)
    rpw = 8 if dense else 1
    p = plane_gemm.plan_launch(b, kw, n, wb, dense, sms)
    assert p.tensor_cores
    kc = p.stage_words
    mem = planes.view(torch.uint8).long()
    xl = x.long()
    off = 1 << (wb - 1)
    out = torch.zeros((b, n), dtype=torch.int64)
    seen = torch.zeros((b, n, kw), dtype=torch.int32)
    gx, gy, gz = p.grid
    for bx in range(gx):
        n0 = bx * 128
        cols = torch.arange(n0, n0 + 128)
        cok = cols < n
        for by in range(gy):
            b0 = by * p.rows
            brows = torch.arange(b0, b0 + p.rows)
            bok = brows < b
            for bz in range(gz):
                lo = bz * p.split_words
                hi = min(kw, lo + p.split_words)
                acc = torch.zeros((p.rows, 128), dtype=torch.int64)
                for kw0 in range(lo, hi, kc):
                    # issue_stage: weight rows [WB, rpw KC, 128], x [rows, 8 KC]
                    grows = kw0 * rpw + torch.arange(rpw * kc)
                    stage = torch.zeros((wb, rpw * kc, 128), dtype=torch.int64)
                    gok = grows < rpp
                    sub = mem[:, grows[gok].clamp(max=rpp - 1)][:, :, cols[cok]]
                    stage[:, gok.nonzero()[:, 0][:, None], cok.nonzero()[:, 0]] \
                        = sub
                    ks = kw0 * 8 + torch.arange(8 * kc)
                    xs = torch.zeros((p.rows, 8 * kc), dtype=torch.int64)
                    kok = ks < k
                    xs[bok.nonzero()[:, 0][:, None], kok.nonzero()[:, 0]] = \
                        xl[brows[bok]][:, ks[kok]]
                    # unpack_stage: raw words [WB, KC, 128] -> int8 tile
                    if dense:
                        raw = sum((stage[:, jj::8] & 1) << jj for jj in range(8))
                    else:
                        raw = stage
                    tile = torch.zeros((8 * kc, 128), dtype=torch.int64)
                    for half in range(2):
                        word = torch.zeros((kc, 128), dtype=torch.int64)
                        for pl in range(wb):
                            nib = (raw[pl] >> (4 * half)) & 0xF
                            word |= _spread4(nib) << pl
                        for byte in range(4):
                            v = (((word >> (8 * byte)) & 0xFF) - off) & 0xFF
                            v = torch.where(v >= 128, v - 256, v)
                            tile[4 * half + byte::8] = v
                    acc += xs @ tile
                    nw = min(kc, hi - kw0)
                    seen[brows[bok][:, None], cols[cok],
                         kw0:kw0 + nw] += 1
                out[brows[bok][:, None], cols[cok]] += \
                    acc[bok][:, cok]
    assert bool((seen == 1).all())
    return out.to(torch.int32)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("bkn", [(17, 100, 77), (40, 64, 200),
                                 (65, 1000, 130), (130, 200, 129)])
def test_tensor_core_schedule_equals_plain(bkn, sms):
    """The tensor-core schedule (stages, zero fill past B, K and N, the
    dense fold, the rebuild, K splits) reproduces ``plane_plain`` and the
    JAX reference's ``bitplane_gemm`` bit for bit; ``sms`` 1 runs every
    stage of K in one block, 132 splits K across blocks."""
    b, k, n = bkn
    rng = np.random.default_rng(b + k + n)
    w = rng.integers(-8, 8, (k, n), dtype=np.int32)
    planes = np.array(jref.pack_bitplanes(jnp.asarray(w), WB))
    words = np.array(jref.pack_plane_words(jnp.asarray(planes)))
    x = _x(b + n, b, k)
    want = x.astype(np.int64) @ w.astype(np.int64)
    got_j = bitplane_gemm(jnp.asarray(x), jnp.asarray(words), mode="folded",
                          interpret=True, layout="bitpack8", logical_k=k)
    np.testing.assert_array_equal(np.asarray(got_j), want)
    tx = torch.from_numpy(x)
    for layout, pl, lk in (("bitpack8", torch.from_numpy(words), k),
                           ("dense", torch.from_numpy(planes), None)):
        plain = plane_gemm.plane_plain(tx, pl, layout=layout, logical_k=lk)
        np.testing.assert_array_equal(plain.numpy(), want)
        assert torch.equal(_emulate_tc(tx, pl, layout, lk, sms), plain)
