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
