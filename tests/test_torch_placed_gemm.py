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

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitplane_gemm import bitplane_gemm_placed  # noqa: E402
from repro.kernels.bitplane_gemv import bitplane_gemv_placed  # noqa: E402
from repro.kernels.ops import pud_matmul as j_pud_matmul  # noqa: E402
from repro.kernels.ops import quantize_activations as j_quant  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ops import pud_matmul, quantize_activations  # noqa: E402
from repro_torch.kernels.placed_gemm import (gemm_placed,  # noqa: E402
                                             gemv_placed, window_cols)

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


def test_cuda_entries_refuse_the_dense_layout_on_gpu_tensors():
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
