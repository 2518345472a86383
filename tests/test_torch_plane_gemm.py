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

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

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
    assert p.stages == plane_gemm.STAGES
    assert p.x_row == 8 * p.stage_words + plane_gemm.PAD
    assert p.x_row % 16 == 0
    assert p.w_stage == WB * (8 if dense else 1) * p.stage_words * 128
    assert p.stage_bytes == p.w_stage + p.rows * p.x_row
    if p.tensor_cores:
        assert p.rows in plane_gemm.TC_ROWS and p.rows >= min(b, 64)
        assert p.stage_words in plane_gemm.STAGE_WORDS
        wt = 2 * p.stage_words * plane_gemm.WT_STRIDE * 4
        assert p.stages * p.stage_bytes + wt <= p.smem_bytes \
            <= plane_gemm.SMEM_MAX
    else:
        assert p.rows in plane_gemm.DP4A_ROWS and p.rows >= b
        assert p.stage_words in plane_gemm.DP4A_WORDS[dense]
        assert p.stages * p.stage_bytes <= p.smem_bytes <= plane_gemm.SMEM_MAX


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("kn", PLAN_KN)
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 15, 16])
def test_decode_plan_stages_and_splits(b, kn, dense):
    """B <= 16 at 132 SMs: the smallest row tile that holds B; the ring of
    ``STAGES`` fits ``RING_BUDGET`` where a stage size of ``DP4A_WORDS``
    does (else the smallest, within ``SMEM_MAX``) and gives each of the 8
    warps at least one unit per stage; K splits in whole stages until about
    two blocks per SM are in flight (at least one after the rounding to
    whole stages, about two on the wi / wo / 2048 x 2048 shapes), or until
    each split is one stage; the warps' partial sums fit the ring's memory;
    fewer SMs, no more splits (fewer on those three shapes)."""
    k, n = kn
    kw = -(-k // 8)
    p = plane_gemm.plan_launch(b, kw, n, WB, dense, 132)
    words = plane_gemm.DP4A_WORDS[dense]
    assert not p.tensor_cores
    assert p.rows == next(r for r in plane_gemm.DP4A_ROWS if r >= b)
    assert p.stage_words in words
    assert (2 if dense else 1) * p.stage_words >= plane_gemm.WARPS
    ring = p.stages * p.stage_bytes
    assert p.smem_bytes == max(ring, plane_gemm.WARPS * 128 * 4)
    fits = [kc for kc in words
            if p.stages * (WB * (8 if dense else 1) * kc * 128
                        + p.rows * (8 * kc + plane_gemm.PAD))
            <= plane_gemm.RING_BUDGET]
    if fits:
        assert p.stage_words in fits and p.smem_bytes <= plane_gemm.RING_BUDGET
    else:
        assert p.stage_words == words[-1]
        assert p.smem_bytes <= plane_gemm.SMEM_MAX
    assert p.split_words % p.stage_words == 0
    assert p.n_split == -(-kw // p.split_words)
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    # whole stages round the split down to at least one block per SM
    assert blocks >= 132 or p.split_words == p.stage_words
    few = plane_gemm.plan_launch(b, kw, n, WB, dense, 16)
    assert few.n_split <= p.n_split
    if kn in ((2048, 6144), (6144, 2048), (2048, 2048)):
        assert blocks >= 1.9 * 132 and few.n_split < p.n_split


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


# ---- a plain emulation of the dp4a (decode) schedule, the kernel's word
# operations on uint32 lanes: 32 lanes of four adjacent columns each.

M32 = 0xFFFFFFFF


def _quads(t):
    """[..., 4 m] bytes -> [..., m] uint32 words, little-endian: a stage
    row's 128 bytes are the 32 lanes' words of four columns (byte c of
    lane q's word: column 4 q + c), an x row's bytes its K quads."""
    t = (t & 0xFF).reshape(*t.shape[:-1], -1, 4)
    return t[..., 0] | t[..., 1] << 8 | t[..., 2] << 16 | t[..., 3] << 24


def _byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)``: byte j of the result is byte
    sel[4 j .. 4 j + 2] of the eight bytes b:a."""
    x = (b << 32) | a
    return sum(((x >> (8 * ((sel >> (4 * j)) & 7))) & 0xFF) << (8 * j)
               for j in range(4))


def _transpose4(r):
    t0, t1 = _byte_perm(r[0], r[1], 0x5140), _byte_perm(r[0], r[1], 0x7362)
    t2, t3 = _byte_perm(r[2], r[3], 0x5140), _byte_perm(r[2], r[3], 0x7362)
    return [_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632)]


def _to_signed(v, wb):
    return ((v + (128 - (1 << (wb - 1))) * 0x01010101) & M32) ^ 0x80808080


def _sbyte(v, j):
    t = (v >> (8 * j)) & 0xFF
    return torch.where(t >= 128, t - 256, t)


def _dp4a(a, b):
    """``__dp4a(a, b, 0)``: four signed int8 products summed."""
    return sum(_sbyte(a, j) * _sbyte(b, j) for j in range(4))


def _swap_bits(x, k, m):
    t = (x ^ (x >> k)) & m
    return (x ^ t ^ (t << k)) & M32


def _rebuild_t(raw, wb):
    """The bit-packed decode rebuild of ``rebuild_t``: a byte transpose
    gathers each column's plane bytes (planes 0-3 and 4-7), three delta
    swaps transpose the 8 x 8 bit matrix, ``to_signed`` takes 2^(WB-1)
    off.  ``raw``: WB [..., 32] words.  Returns (lo, hi) lists of four
    [..., 32] words (K rows 0-3 and 4-7 of column 4 q + c)."""
    zero = torch.zeros_like(raw[0])
    raw = list(raw) + [zero] * (8 - len(raw))
    lo4, hi4 = _transpose4(raw[:4]), _transpose4(raw[4:])
    lo, hi = [], []
    for c in range(4):
        a = _swap_bits(_swap_bits(lo4[c], 7, 0x00AA00AA), 14, 0x0000CCCC)
        b = _swap_bits(_swap_bits(hi4[c], 7, 0x00AA00AA), 14, 0x0000CCCC)
        t = (a ^ (b << 4)) & 0xF0F0F0F0
        lo.append(_to_signed(a ^ t, wb))
        hi.append(_to_signed(b ^ (t >> 4), wb))
    return lo, hi


def _emulate_dp4a(x, planes, layout, logical_k, sms):
    """The dp4a schedule in plain PyTorch: per block (128 columns, ``rows``
    x rows, one K split) and stage, the staged weight and x rows
    zero-filled as ``issue_stage`` fills them; each unit of the stage (a
    K word, or four dense rows) rebuilt as the kernel does it on 32 lanes
    of four columns (bit-packed: ``rebuild_t``; dense: the planes added at
    their shift, the byte transpose, ``to_signed``) and multiplied by
    ``__dp4a``; the partial sums of the blocks of a K split added."""
    dense = layout == "dense"
    b, k = x.shape
    wb, rpp, n = planes.shape
    kw = -(-k // 8)
    rpw = 8 if dense else 1
    p = plane_gemm.plan_launch(b, kw, n, wb, dense, sms)
    assert not p.tensor_cores
    kc = p.stage_words
    mem = planes.view(torch.uint8).long()
    xl = x.long()
    out = torch.zeros((b, n), dtype=torch.int64)
    seen = torch.zeros((n, kw), dtype=torch.int32)
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
                    grows = kw0 * rpw + torch.arange(rpw * kc)
                    stage = torch.zeros((wb, rpw * kc, 128), dtype=torch.int64)
                    gok = grows < rpp
                    stage[:, gok.nonzero()[:, 0][:, None],
                          cok.nonzero()[:, 0]] = \
                        mem[:, grows[gok]][:, :, cols[cok]]
                    ks = kw0 * 8 + torch.arange(8 * kc)
                    xs = torch.zeros((p.rows, 8 * kc), dtype=torch.int64)
                    kok = ks < k
                    xs[bok.nonzero()[:, 0][:, None], kok.nonzero()[:, 0]] = \
                        xl[brows[bok]][:, ks[kok]]
                    xw = _quads(xs)                # [rows, 2 KC] x words
                    nw = min(kc, hi - kw0)
                    seen[cols[cok], kw0:kw0 + nw] += 1
                    q = _quads(stage)              # [WB, rpw KC, 32]
                    part = torch.zeros((p.rows, 4, 32), dtype=torch.int64)
                    if dense:
                        for u in range(2 * nw):
                            v = [sum(q[pl, 4 * u + i] << pl
                                     for pl in range(wb)) for i in range(4)]
                            w = torch.stack([_to_signed(t, wb)
                                             for t in _transpose4(v)])
                            part += _dp4a(xw[:, u, None, None], w)
                    else:
                        for u in range(nw):
                            wl, wh = _rebuild_t([q[pl, u] for pl in range(wb)],
                                                wb)
                            part += (_dp4a(xw[:, 2 * u, None, None],
                                           torch.stack(wl))
                                     + _dp4a(xw[:, 2 * u + 1, None, None],
                                             torch.stack(wh)))
                    # lane q's column c is column 4 q + c
                    acc += part.transpose(1, 2).reshape(p.rows, 128)
                out[brows[bok][:, None], cols[cok]] += acc[bok][:, cok]
    assert bool((seen == 1).all())
    return out.to(torch.int32)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("bkn", [(1, 100, 133), (4, 200, 130),
                                 (16, 300, 129), (3, 150, 200)])
@pytest.mark.parametrize("wb", range(1, 9))
def test_decode_schedule_equals_plain(wb, bkn, sms):
    """The dp4a schedule (stages, zero fill past B, K and N, both
    rebuilds, K splits in whole stages) reproduces ``plane_plain`` bit for
    bit for every plane count 1 to 8 (4 and 8 compiled, the rest at run
    time), both layouts; ``sms`` 1 runs every stage of K in one block (two
    column tiles fill one SM twice), 132 splits K across blocks."""
    b, k, n = bkn
    rng = np.random.default_rng(wb * 1000 + b + k + n)
    half = 1 << (wb - 1)
    w = rng.integers(-half, half, (k, n), dtype=np.int32)
    planes = ref.pack_bitplanes(torch.from_numpy(w), wb)
    words = ref.pack_plane_words(planes)
    x = torch.from_numpy(_x(b + n, b, k))
    want = x.numpy().astype(np.int64) @ w.astype(np.int64)
    for layout, pl, lk in (("bitpack8", words, k), ("dense", planes, None)):
        plain = plane_gemm.plane_plain(x, pl, layout=layout, logical_k=lk)
        np.testing.assert_array_equal(plain.numpy(), want)
        split = plane_gemm.plan_launch(b, -(-k // 8), n, wb,
                                       layout == "dense", sms).n_split
        assert (split > 1) == (sms > 1)
        assert torch.equal(_emulate_dp4a(x, pl, layout, lk, sms), plain)
