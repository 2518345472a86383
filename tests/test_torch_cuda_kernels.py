"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: they skip where no CUDA device is present (the CPU parity
tests reach the same code paths through the plain versions).  On a machine
with a GPU and no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \
        tests/test_torch_cuda_kernels.py

Every comparison is exact: the kernels compute integers (GEMM) or follow
the plain version's float operations one by one (calibration).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.fleet import FleetConfig, ladder_tables  # noqa: E402
from repro_torch.kernels import calib_iter, placed_gemm, plane_gemm, ref  # noqa: E402,E501
from repro_torch.kernels.ops import pud_matmul  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("shape", [((), 256, 65536), ((3,), 64, 1000),
                                   ((2,), 5, 77)])
def test_calib_iter_equals_plain(gen, shape):
    lead, s, c = shape
    p = PhysicsParams()
    ladder = FleetConfig().ladder(p)
    qsum, swing = ladder_tables(ladder, p)
    bits = torch.randint(0, 2, lead + (s, 5, c), generator=gen, device="cuda",
                         dtype=torch.uint8)
    noise = torch.randn(lead + (s, c), generator=gen, device="cuda")
    levels = torch.randint(0, ladder.n_levels, lead + (c,), generator=gen,
                           device="cuda", dtype=torch.int32)
    offs = 0.033 * torch.randn(lead + (c,), generator=gen, device="cuda")
    args = (p, ladder.n_fracs, qsum, swing, 0.0009, 5)
    before = calib_iter.calib_iter.launches
    got = calib_iter.calib_iter(bits, noise, levels, offs, *args)
    want = calib_iter.calib_iter_plain(bits, noise, levels, offs, *args)
    assert calib_iter.calib_iter.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):          # float bits are not taken
        calib_iter.calib_iter(bits.float(), noise, levels, offs, *args)


def _window(gen, k, n, blocked):
    w = torch.randint(-8, 8, (k, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    planes = ref.pack_bitplanes(w, 4)
    if blocked:
        bc, pwb = min(n, 128), min(n, 128) + 32
        cols = torch.cat([j * pwb + torch.randperm(pwb, generator=gen,
                                                   device="cuda")[:bc]
                          for j in range(n // bc)])
        w_len = (n // bc) * pwb
    else:
        pwb, w_len = None, n + 64
        cols = torch.randperm(w_len, generator=gen, device="cuda")[:n]
    window = torch.zeros((4, k, w_len), dtype=torch.int8, device="cuda")
    window[:, :, cols] = planes
    return w, window, ref.pack_plane_words(window), cols.to(torch.int32), pwb


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("k", [64, 100, 2048])
@pytest.mark.parametrize("b", [1, 3, 8, 17, 128])
def test_placed_gemm_equals_plain(gen, b, k, blocked):
    w, window, words, cols, pwb = _window(gen, k, 512, blocked)
    x = torch.randint(-127, 128, (b, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    kw = dict(layout="bitpack8", logical_k=k, window_block=pwb)
    want = (x.double() @ w.double()).to(torch.int32)
    assert torch.equal(placed_gemm.placed_plain(x, words, cols, **kw), want)
    for mode in ("planes", "folded"):
        n0 = placed_gemm.gemm_placed.launches
        assert torch.equal(
            placed_gemm.gemm_placed(x, words, cols, mode, **kw), want)
        assert placed_gemm.gemm_placed.launches == n0 + 1
        if b == 1:
            assert torch.equal(
                placed_gemm.gemv_placed(x, words, cols, mode, **kw), want)
    with pytest.raises(NotImplementedError):
        placed_gemm.gemm_placed(x, window, cols, layout="dense",
                                window_block=pwb)
    if b > 1:
        with pytest.raises(ValueError):
            placed_gemm.gemv_placed(x, words, cols, **kw)


@pytest.mark.parametrize("n", [77, 200, 2048])
@pytest.mark.parametrize("k", [64, 100, 2048, 6144])
@pytest.mark.parametrize("b", [1, 3, 8, 17, 128])
def test_plane_gemm_equals_plain(gen, b, k, n):
    w = torch.randint(-8, 8, (2, k, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    # two stacked layers: layer 1 starts at an offset that is not 4-byte
    # aligned when N is odd, which takes the kernel's byte-load path
    words = torch.stack([ref.pack_plane_words(ref.pack_bitplanes(w[i], 4))
                         for i in range(2)])
    x = torch.randint(-127, 128, (b, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    for layer in range(2):
        want = (x.double() @ w[layer].double()).to(torch.int32)
        wl = words[layer]
        assert torch.equal(plane_gemm.plane_plain(
            x, wl, layout="bitpack8", logical_k=k), want)
        for mode in ("planes", "folded"):
            n0 = plane_gemm.gemm.launches
            assert torch.equal(plane_gemm.gemm(x, wl, mode, logical_k=k),
                               want)
            assert plane_gemm.gemm.launches == n0 + 1
            if b == 1:
                v0 = plane_gemm.gemv.launches
                assert torch.equal(plane_gemm.gemv(x, wl, mode, logical_k=k),
                                   want)
                assert plane_gemm.gemv.launches == v0 + 1
    with pytest.raises(NotImplementedError):
        plane_gemm.gemm(x, ref.pack_bitplanes(w[0], 4), layout="dense")
    if b > 1:
        with pytest.raises(ValueError):
            plane_gemm.gemv(x, words[0], logical_k=k)


@pytest.mark.parametrize("b", [1, 4])
def test_pud_matmul_cuda_equals_reference_backend(gen, b):
    _, _, words, cols, pwb = _window(gen, 100, 256, True)
    x = torch.randn((b, 100), generator=gen, device="cuda")
    scale = torch.rand(256, generator=gen, device="cuda") + 0.01
    kw = dict(col_ids=cols, layout="bitpack8", logical_k=100,
              window_block=pwb)
    got = pud_matmul(x, words, scale, backend="cuda", **kw)
    want = pud_matmul(x, words, scale, backend="reference", **kw)
    assert torch.equal(got, want)
    kw.update(col_ids=None, window_block=None)     # the unplaced kernels
    logical = words[:, :, :200].contiguous()
    got = pud_matmul(x, logical, scale[:200], backend="cuda", **kw)
    want = pud_matmul(x, logical, scale[:200], backend="reference", **kw)
    assert torch.equal(got, want)
