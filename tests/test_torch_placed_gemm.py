"""Parity of the port's placed bit-plane GEMM/GEMV plain versions and the
quantize -> GEMM -> dequantize dispatch with the JAX package.

Integer results are exact: the port's plain versions equal the reference's
Pallas kernels (interpret mode) and its jnp oracle over ragged batches, a K
that is not a multiple of 8, block-aligned and single-block windows, both
execution modes and both plane layouts.  ``pud_matmul`` is bit-equal for
float32 activations (the dequant multiplies in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitplane_gemm import bitplane_gemm_placed  # noqa: E402
from repro.kernels.bitplane_gemv import bitplane_gemv_placed  # noqa: E402
from repro.kernels.ops import pud_matmul as j_pud_matmul  # noqa: E402
from repro.kernels.ops import quantize_activations as j_quant  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ops import pud_matmul, quantize_activations  # noqa: E402
from repro_torch.kernels.placed_gemm import (MAX_COPIES, SMEM_MAX,  # noqa: E402
                                             SMS, THREADS,
                                             gemm_placed, gemv_placed,
                                             placed_plain, plan_launch,
                                             window_cols, window_tiling)

N, WB = 256, 4


def _window(seed, k, blocked):
    """A placed window: logical columns scattered into a block-aligned
    window (two window blocks of stride 160) or one 320-wide block."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-8, 8, (k, N), dtype=np.int32)
    planes = np.asarray(ref.pack_bitplanes(torch.from_numpy(w), WB))
    if blocked:
        bc, pwb = 128, 160
        col_ids = np.concatenate([j * pwb + rng.permutation(pwb)[:bc]
                                  for j in range(N // bc)])
        w_len = (N // bc) * pwb
    else:
        pwb, w_len = None, 320
        col_ids = rng.permutation(w_len)[:N]
    window = np.zeros((WB, k, w_len), np.int8)
    window[:, :, col_ids] = planes
    words = np.array(jref.pack_plane_words(jnp.asarray(window)))
    return w, window, words, col_ids.astype(np.int32), pwb


def _x(seed, b, k):
    rng = np.random.default_rng(seed + 100)
    return rng.integers(-127, 128, (b, k), dtype=np.int64).astype(np.int8)


def test_pack_helpers_match_reference():
    rng = np.random.default_rng(0)
    w = rng.integers(-8, 8, (100, 48), dtype=np.int32)
    planes = ref.pack_bitplanes(torch.from_numpy(w), WB)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(jref.pack_bitplanes(jnp.asarray(w), WB)))
    words = ref.pack_plane_words(planes)
    np.testing.assert_array_equal(
        words.numpy(), np.asarray(jref.pack_plane_words(jnp.asarray(
            planes.numpy()))))
    np.testing.assert_array_equal(
        ref.unpack_plane_words(words, 100).numpy(), planes.numpy())


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("k", [64, 100])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_placed_plain_matches_reference(b, k, blocked):
    w, window, words, col_ids, pwb = _window(b * 10 + k, k, blocked)
    x = _x(k, b, k)
    want = np.asarray(jref.bitplane_gemv_placed_ref(
        jnp.asarray(x), jnp.asarray(window), jnp.asarray(col_ids)))
    np.testing.assert_array_equal(want, x.astype(np.int64) @ w)
    tx, tw, tc = map(torch.from_numpy, (x, words, col_ids))
    for mode in ("planes", "folded"):
        got_j = bitplane_gemm_placed(
            jnp.asarray(x), jnp.asarray(words), jnp.asarray(col_ids),
            mode=mode, interpret=True, layout="bitpack8", logical_k=k,
            window_block=pwb)
        np.testing.assert_array_equal(np.asarray(got_j), want)
        port = gemm_placed(tx, tw, tc, mode, layout="bitpack8",
                           logical_k=k, window_block=pwb)
        assert port.dtype == torch.int32 and port.shape == (b, N)
        np.testing.assert_array_equal(port.numpy(), want)
        dense = gemm_placed(tx, torch.from_numpy(window), tc, mode,
                            layout="dense", window_block=pwb)
        np.testing.assert_array_equal(dense.numpy(), want)
        if b == 1:
            got_v = bitplane_gemv_placed(
                jnp.asarray(x), jnp.asarray(words), jnp.asarray(col_ids),
                mode=mode, interpret=True, layout="bitpack8", logical_k=k,
                window_block=pwb)
            np.testing.assert_array_equal(np.asarray(got_v), want)
            np.testing.assert_array_equal(
                gemv_placed(tx, tw, tc, mode, layout="bitpack8",
                            logical_k=k, window_block=pwb).numpy(), want)


def test_window_addressing_reads_the_residue_in_its_own_block():
    """Like the reference kernel, column n reads window column
    ``(n // block_cols) * window_block + col_ids[n] % window_block``."""
    col_ids = torch.tensor([5, 1, 9, 7], dtype=torch.int32)
    np.testing.assert_array_equal(
        window_cols(col_ids, 8, 4).numpy(), [1, 1, 5, 7])
    np.testing.assert_array_equal(window_cols(col_ids, 12, None).numpy(),
                                  [5, 1, 9, 7])
    with pytest.raises(ValueError):
        window_cols(col_ids, 12, 5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_activations_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (3.0 * rng.standard_normal((5, 100))).astype(np.float32)
    x[2] = 0.0                                   # the eps floor
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else dtype)
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == "bfloat16"
                                else torch.float32)
    q, s = quantize_activations(tx)
    jq, js = j_quant(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js, np.float32))
    assert q.dtype == torch.int8 and s.dtype == tx.dtype


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("b", [1, 4])
def test_pud_matmul_bit_equal_for_float32(backend, b):
    """On CPU tensors the ``cuda`` backend runs the plain versions, so both
    backends must equal the reference's dispatch bit for bit."""
    k = 100
    _, _, words, col_ids, pwb = _window(9, k, True)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, k)).astype(np.float32)
    w_scale = (0.01 + rng.random(N)).astype(np.float32)
    want = j_pud_matmul(jnp.asarray(x), jnp.asarray(words),
                        jnp.asarray(w_scale), col_ids=jnp.asarray(col_ids),
                        backend="reference", layout="bitpack8", logical_k=k,
                        window_block=pwb)
    got = pud_matmul(torch.from_numpy(x), torch.from_numpy(words),
                     torch.from_numpy(w_scale),
                     col_ids=torch.from_numpy(col_ids), backend=backend,
                     layout="bitpack8", logical_k=k, window_block=pwb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_launch_gate_refuses_unreadable_dense_windows():
    """The kernel now takes dense planes; what it refuses is a dense window
    it cannot read: K that disagrees with x, a wider element type, or a
    ``logical_k`` that names another K.  The launch gate raises before any
    build, never falls back (checked without a GPU)."""
    from repro_torch.kernels.placed_gemm import _launch
    x = torch.zeros((1, 8), dtype=torch.int8)
    cols = torch.zeros(8, dtype=torch.int32)
    for planes, logical_k in ((torch.zeros((4, 16, 8), dtype=torch.int8), None),
                              (torch.zeros((4, 8, 8), dtype=torch.int32), None),
                              (torch.zeros((4, 8, 8), dtype=torch.int8), 16)):
        with pytest.raises(ValueError):
            _launch("gemm_placed", x, planes, cols, "folded", "dense",
                    logical_k, None)


# Main-path shapes of qwen3-1.7b (wi/wg, wo, unembed at a calibrated ECR
# near 3.7%: window blocks a few percent wider than their logical blocks)
# and the GPU tests' shapes: (B, K, N, WB, window_block, block_cols).
MAIN_SHAPES = [(b, 2048, 6144, 4, 272, 256) for b in (1, 4, 16, 128)] + \
    [(b, 6144, 2048, 4, 272, 256) for b in (1, 4, 16, 128)] + \
    [(b, 2048, 151936, 4, 141, 128) for b in (1, 4)] + \
    [(b, 2048, 2048, 4, 288, 256) for b in (1, 8)]
GPU_SHAPES = [(b, k, n, wb, pwb, bc)
              for b in (1, 3, 4, 5, 16, 17, 32, 128)
              for wb, k, n in ((1, 64, 512), (4, 100, 2048), (8, 2048, 512),
                               (4, 6144, 2048), (4, 2048, 6144),
                               (8, 6144, 6144))
              for pwb, bc in ((min(n, 256) + 27, min(n, 256)),
                              (n + 63, n))]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", MAIN_SHAPES + GPU_SHAPES)
def test_plan_covers_its_operands(shape, dense):
    """K splits cover every word once in whole stages; tiles cover every
    column of a window block; a staged row holds the whole span at any
    16-byte misalignment; shared memory fits one block."""
    b, k, n, wb, pwb, bc = shape
    kw = -(-k // 8)
    p = plan_launch(b, kw, n, wb, pwb, bc, dense)
    assert p.tensor_cores == (b >= 17)
    assert p.split_words % p.stage_words == 0
    spans = [(z * p.split_words, min(kw, (z + 1) * p.split_words))
             for z in range(p.n_split)]
    assert spans[0][0] == 0 and spans[-1][1] == kw
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    assert (p.tiles_per_block - 1) * p.tile_cols < bc <= \
        p.tiles_per_block * p.tile_cols
    assert p.grid == ((n // bc) * p.tiles_per_block, -(-b // p.rows),
                      p.n_split)
    if p.staged:
        assert p.row_bytes % 16 == 0 and p.row_bytes >= 15 + pwb
        assert p.w_stage == wb * (8 if dense else 1) * p.stage_words * \
            p.row_bytes
        assert wb * (8 if dense else 1) * p.stage_words * p.row_bytes \
            <= 16 * MAX_COPIES * THREADS
        assert p.tab_bytes >= 4 * wb * (8 if dense else 1) * p.stage_words
        assert p.pk_row >= (pwb + 3 if dense else 0)
    assert p.x_row % 16 == 0 and p.x_row >= 8 * p.stage_words
    assert p.stage_bytes == p.w_stage + p.rows * p.x_row + p.tab_bytes
    assert p.stage_bytes * p.stages <= p.smem_bytes <= SMEM_MAX


@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_plan_fills_the_card_at_decode(shape):
    """The main path's packs are staged, and at N = 2048 and 6144 a decode
    batch reaches at least one block per SM."""
    b, k, n, wb, pwb, bc = shape
    p = plan_launch(b, -(-k // 8), n, wb, pwb, bc, False)
    assert p.staged
    if b <= 16 and n in (2048, 6144):
        assert p.grid[0] * p.grid[1] * p.grid[2] >= SMS


def _emulate(x, planes, col_ids, layout, logical_k, window_block, base):
    """The kernel's schedule in plain PyTorch, for planes that start
    ``base`` bytes past a 16-byte boundary: per window block and K split,
    each staged row is copied in the 16-byte granules the kernel copies,
    each column is gathered at its row's misalignment plus its in-span
    column, and the splits' partial products are summed."""
    dense = layout == "dense"
    b, k = x.shape
    wb, rpp, w_len = planes.shape
    (n,) = col_ids.shape
    kw = -(-k // 8)
    rpw = 8 if dense else 1
    pwb, bc = window_tiling(n, w_len, window_block, "emulate")
    p = plan_launch(b, kw, n, wb, pwb, bc, dense)
    size = planes.numel()
    mem = torch.cat([torch.full((base,), 0xA5, dtype=torch.uint8),
                     planes.view(torch.uint8).reshape(-1),
                     torch.full((32,), 0xA5, dtype=torch.uint8)])
    xp = torch.nn.functional.pad(x, (0, 8 * kw - k)).double()
    out = torch.zeros((b, n), dtype=torch.float64)
    seen = torch.zeros((kw * 8, n), dtype=torch.int32)
    for blk in range(n // bc):
        start = blk * pwb
        res = col_ids[blk * bc:(blk + 1) * bc].long() % pwb
        for z in range(p.n_split):
            lo, hi = z * p.split_words, min(kw, (z + 1) * p.split_words)
            bits = torch.zeros((wb, 8 * kw, bc), dtype=torch.int32)
            for kw0 in range(lo, hi, p.stage_words):
                for q in range(rpw * p.stage_words):
                    grow = kw0 * rpw + q
                    if grow >= rpp or grow // rpw >= hi:
                        continue
                    for pl in range(wb):
                        addr = base + (pl * rpp + grow) * w_len + start
                        if p.staged:
                            mis = addr % 16
                            ng = -(-(mis + pwb) // 16)
                            assert 16 * ng <= p.row_bytes
                            al = addr - mis
                            assert al < base + size and al + 16 * ng > base
                            row = mem[al:al + 16 * ng]
                            assert int((mis + res).max()) < row.numel()
                            val = row[mis + res].int()
                        else:
                            val = mem[addr + res].int()
                        if dense:
                            bits[pl, grow] = val & 1
                        else:
                            for j in range(8):
                                bits[pl, 8 * grow + j] = (val >> j) & 1
            w = sum(bits[i] << i for i in range(wb)) - (1 << (wb - 1))
            kr = slice(8 * lo, 8 * hi)
            out[:, blk * bc:(blk + 1) * bc] += xp[:, kr] @ w[kr].double()
            seen[kr, blk * bc:(blk + 1) * bc] += 1
    assert bool((seen == 1).all())
    return out.to(torch.int32)


@pytest.mark.parametrize("base", [0, 5])
@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("k", [64, 100])
@pytest.mark.parametrize("b", [1, 4, 17])
def test_staged_schedule_equals_plain(b, k, blocked, base):
    """The plan's staging offsets and K splits reproduce the plain version
    on random placements, ``window_block=None`` included."""
    w, window, words, col_ids, pwb = _window(b * 7 + k, k, blocked)
    x = torch.from_numpy(_x(k + 1, b, k))
    tc = torch.from_numpy(col_ids)
    for layout, planes, lk in (("bitpack8", torch.from_numpy(words), k),
                               ("dense", torch.from_numpy(window), None)):
        want = placed_plain(x, planes, tc, layout=layout, logical_k=lk,
                            window_block=pwb)
        np.testing.assert_array_equal(want.numpy(), x.numpy().astype(
            np.int64) @ w)
        got = _emulate(x, planes, tc, layout, lk, pwb, base)
        assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 17])
def test_unstaged_schedule_equals_plain(b):
    """A whole-window dense pack too wide for a stage: the plan stages
    nothing and lanes read their bytes directly; still exact."""
    rng = np.random.default_rng(b)
    k, n, w_len = 24, 2048, 2100
    w = rng.integers(-8, 8, (k, n), dtype=np.int32)
    col_ids = rng.permutation(w_len)[:n].astype(np.int32)
    window = np.zeros((WB, k, w_len), np.int8)
    window[:, :, col_ids] = np.asarray(ref.pack_bitplanes(
        torch.from_numpy(w), WB))
    assert not plan_launch(b, 3, n, WB, w_len, n, True).staged
    x = torch.from_numpy(_x(3, b, k))
    planes, tc = torch.from_numpy(window), torch.from_numpy(col_ids)
    want = placed_plain(x, planes, tc, layout="dense")
    np.testing.assert_array_equal(want.numpy(),
                                  x.numpy().astype(np.int64) @ w)
    assert torch.equal(_emulate(x, planes, tc, "dense", None, None, 3), want)
