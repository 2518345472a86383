"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: they skip where no CUDA device is present (the CPU parity
tests reach the same code paths through the plain versions).  On a machine
with a GPU and no JAX, run them without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu \
        tests/test_torch_cuda_kernels.py

Every comparison is exact: the kernels compute integers (GEMM) or follow
the plain version's float operations one by one (calibration, sensing).
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro_torch.core.fleet import FleetConfig, ladder_tables  # noqa: E402
from repro_torch.kernels import (calib_iter, ops, placed_gemm,  # noqa: E402
                                  plane_gemm, ref, sense)
from repro_torch.kernels.ops import pud_matmul  # noqa: E402
from repro_torch.pud import device  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _calib_operands(gen, lead, s, m, c, shift=0):
    """Operands of one calib_iter call; ``shift`` > 0 starts every tensor
    that many elements into its storage, so no pointer is 16-byte aligned
    (the kernel's byte path at any C)."""
    def alloc(fn, shape, **kw):
        n = 1
        for d in shape:
            n *= d
        return fn((n + shift,), generator=gen, device="cuda", **kw)[
            shift:].view(shape)
    p = PhysicsParams()
    ladder = FleetConfig().ladder(p)
    qsum, swing = ladder_tables(ladder, p)
    bits = alloc(lambda *a, **kw: torch.randint(0, 2, *a, **kw),
                 lead + (s, m, c), dtype=torch.uint8)
    noise = alloc(torch.randn, lead + (s, c))
    levels = alloc(lambda *a, **kw: torch.randint(0, ladder.n_levels, *a,
                                                  **kw),
                   lead + (c,), dtype=torch.int32)
    offs = alloc(torch.randn, lead + (c,)).mul_(0.033)
    args = (p, ladder.n_fracs, qsum, swing, 0.0009, m)
    return bits, noise, levels, offs, args


@pytest.mark.parametrize("shape", [((), 256, 5, 65536), ((3,), 64, 5, 1000),
                                   ((2,), 5, 5, 77), ((3,), 64, 5, 1001),
                                   ((2,), 33, 3, 4096), ((3,), 64, 3, 1001),
                                   ((2,), 64, 7, 4096), ((1,), 17, 7, 1001)])
def test_calib_iter_equals_plain(gen, shape):
    lead, s, m, c = shape
    bits, noise, levels, offs, args = _calib_operands(gen, lead, s, m, c)
    before = calib_iter.calib_iter.launches
    got = calib_iter.calib_iter(bits, noise, levels, offs, *args)
    want = calib_iter.calib_iter_plain(bits, noise, levels, offs, *args)
    assert calib_iter.calib_iter.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):          # float bits are not taken
        calib_iter.calib_iter(bits.float(), noise, levels, offs, *args)


@pytest.mark.parametrize("m", [3, 5])
def test_calib_iter_unaligned_pointers_take_the_byte_path(gen, m):
    """C a multiple of 4 but no pointer 16-byte aligned: the plan takes
    the byte path and the kernel still equals the plain version."""
    bits, noise, levels, offs, args = _calib_operands(gen, (2,), 40, m,
                                                      4096, shift=1)
    assert noise.data_ptr() % 16 and bits.is_contiguous()
    before = calib_iter.calib_iter.launches
    got = calib_iter.calib_iter(bits, noise, levels, offs, *args)
    want = calib_iter.calib_iter_plain(bits, noise, levels, offs, *args)
    assert calib_iter.calib_iter.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
        # the dense window, read by the kernel itself
        dkw = dict(layout="dense", window_block=pwb)
        n0 = placed_gemm.gemm_placed.launches
        assert torch.equal(
            placed_gemm.gemm_placed(x, window, cols, mode, **dkw), want)
        assert placed_gemm.gemm_placed.launches == n0 + 1
        if b == 1:
            assert torch.equal(
                placed_gemm.gemv_placed(x, window, cols, mode, **dkw), want)
    if b > 1:
        with pytest.raises(ValueError):
            placed_gemm.gemv_placed(x, words, cols, **kw)


def _odd_window(gen, wb, k, n, blocked):
    """Layer 1 of two stacked placed windows with an odd window block
    (``bc + 27``), so neither W nor any span start nor layer 1's base is
    16-byte aligned; ``blocked=False``: one whole-window block."""
    w = torch.randint(-(1 << (wb - 1)), 1 << (wb - 1), (k, n), generator=gen,
                      device="cuda", dtype=torch.int32)
    if blocked:
        bc = min(n, 256)
        pwb = bc + 27
    else:
        bc, pwb = n, n + 63
    nb = n // bc
    cols = torch.cat([j * pwb + torch.randperm(pwb, generator=gen,
                                               device="cuda")[:bc]
                      for j in range(nb)])
    window = torch.zeros((2, wb, k, nb * pwb), dtype=torch.int8,
                         device="cuda")
    window[1][:, :, cols] = ref.pack_bitplanes(w, wb)
    words = torch.stack([ref.pack_plane_words(window[i]) for i in range(2)])
    return (w, window[1], words[1], cols.to(torch.int32),
            pwb if blocked else None)


def _check_placed(x, w, window, words, cols, pwb):
    """Both layouts, both modes, both entries where B = 1: equal to x @ W
    and to the plain version, one launch counted per call."""
    k = x.shape[1]
    want = (x.double() @ w.double()).to(torch.int32)
    for planes, kw in ((words, dict(layout="bitpack8", logical_k=k)),
                       (window, dict(layout="dense"))):
        kw["window_block"] = pwb
        assert torch.equal(placed_gemm.placed_plain(x, planes, cols, **kw),
                           want)
        for mode in ("planes", "folded"):
            n0 = placed_gemm.gemm_placed.launches
            assert torch.equal(
                placed_gemm.gemm_placed(x, planes, cols, mode, **kw), want)
            assert placed_gemm.gemm_placed.launches == n0 + 1
            if x.shape[0] == 1:
                v0 = placed_gemm.gemv_placed.launches
                assert torch.equal(
                    placed_gemm.gemv_placed(x, planes, cols, mode, **kw),
                    want)
                assert placed_gemm.gemv_placed.launches == v0 + 1
    return want


@pytest.mark.parametrize("b", [1, 3, 4, 5, 16, 17, 32, 128])
@pytest.mark.parametrize("wb,k,n,blocked", [
    (1, 64, 512, True), (4, 100, 2048, True), (8, 2048, 512, True),
    (4, 6144, 2048, True), (4, 2048, 6144, True), (8, 6144, 6144, True),
    (4, 2048, 6144, False)])
def test_placed_gemm_geometry_equals_plain(gen, b, wb, k, n, blocked):
    """WB 1 to 8, the dp4a and tensor-core paths, K splits, odd window
    blocks on an unaligned base; the whole-window case at N = 6144 is too
    wide to stage in the dense layout (and at B >= 17 in both), so those
    lanes read device memory directly."""
    w, window, words, cols, pwb = _odd_window(gen, wb, k, n, blocked)
    x = torch.randint(-127, 128, (b, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    _check_placed(x, w, window, words, cols, pwb)
    if not blocked:
        plan = placed_gemm.plan_launch(b, -(-k // 8), n, wb,
                                       window.shape[-1], n, True)
        assert not plan.staged


@pytest.mark.parametrize("b", [1, 4, 128])
def test_placed_gemm_on_a_planned_placement(gen, b):
    """Columns placed by ``plan_placement`` around about 4% faulty columns
    (runs of up to three), as the main path places them."""
    import numpy as np
    from repro_torch.pud.placement import PlacementRequest, plan_placement
    rng = np.random.default_rng(0)
    masks = rng.random((2, 16384)) < 0.03
    runs = rng.integers(0, 2 * 16384, 60)
    flat = masks.reshape(-1)
    for r in runs:
        flat[r:r + 3] = True
    k, n = 2048, 6144
    pl = plan_placement(masks, [PlacementRequest("w", n)])
    tp = pl.entries["w"]
    assert tp.block_cols == 256 and tp.window_block > 256
    w = torch.randint(-8, 8, (k, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    cols = torch.from_numpy(tp.local_cols).to("cuda")
    window = torch.zeros((4, k, tp.region_size), dtype=torch.int8,
                         device="cuda")
    window[:, :, cols.long()] = ref.pack_bitplanes(w, 4)
    x = torch.randint(-127, 128, (b, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    _check_placed(x, w, window, ref.pack_plane_words(window), cols,
                  tp.window_block)


@pytest.mark.parametrize("layout", ["bitpack8", "dense"])
def test_placed_gemm_is_batch_invariant(gen, layout):
    """Row b of a B-row call equals the one-row call on that row, on both
    sides of the dp4a / tensor-core threshold."""
    w, window, words, cols, pwb = _odd_window(gen, 4, 2048, 2048, True)
    planes = words if layout == "bitpack8" else window
    kw = dict(layout=layout, window_block=pwb)
    x = torch.randint(-127, 128, (40, 2048), generator=gen, device="cuda",
                      dtype=torch.int8)
    full = placed_gemm.gemm_placed(x, planes, cols, **kw)
    for rows in (4, 16, 17, 32):
        assert torch.equal(placed_gemm.gemm_placed(x[:rows], planes, cols,
                                                   **kw), full[:rows])
    for i in range(40):
        one = placed_gemm.gemv_placed(x[i:i + 1], planes, cols, **kw)
        assert torch.equal(one, full[i:i + 1])


@pytest.mark.parametrize("n", [77, 200, 2048])
@pytest.mark.parametrize("k", [64, 100, 2048, 6144])
@pytest.mark.parametrize("b", [1, 3, 8, 16, 17, 63, 64, 65, 128, 129])
def test_plane_gemm_equals_plain(gen, b, k, n):
    """Both sides of the dp4a / tensor-core threshold (17 rows) and of
    the 64-row tensor-core tile, K splits, ragged N and K, both layouts,
    on an aligned layer 0 and a layer 1 that starts unaligned when N is
    not a multiple of 16 (the byte-staged path)."""
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
    # dense planes; layer 1 of the stack starts unaligned when N is odd
    dense = torch.stack([ref.pack_bitplanes(w[i], 4) for i in range(2)])
    for layer in range(2):
        want = (x.double() @ w[layer].double()).to(torch.int32)
        for mode in ("planes", "folded"):
            n0 = plane_gemm.gemm.launches
            assert torch.equal(plane_gemm.gemm(x, dense[layer], mode,
                                               layout="dense"), want)
            assert plane_gemm.gemm.launches == n0 + 1
            if b == 1:
                assert torch.equal(plane_gemm.gemv(
                    x, dense[layer], mode, layout="dense"), want)
    if b > 1:
        with pytest.raises(ValueError):
            plane_gemm.gemv(x, words[0], logical_k=k)


@pytest.mark.parametrize("kn", [(100, 77), (2048, 200), (6144, 2048)])
@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("wb", [1, 3, 4, 8])
def test_plane_gemm_plane_counts_equal_plain(gen, wb, b, kn):
    """Every dp4a kernel instance: the compiled plane counts (WB 4 and 8)
    and the one that takes WB at run time (WB 1 and 3), at each row tile,
    both layouts, on an aligned layer 0 and a layer 1 that starts
    unaligned when N is odd (the byte-staged path)."""
    k, n = kn
    half = 1 << (wb - 1)
    w = torch.randint(-half, half, (2, k, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    dense = torch.stack([ref.pack_bitplanes(w[i], wb) for i in range(2)])
    words = torch.stack([ref.pack_plane_words(dense[i]) for i in range(2)])
    x = torch.randint(-127, 128, (b, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    for layer in range(2):
        want = (x.double() @ w[layer].double()).to(torch.int32)
        for layout, planes, lk in (("bitpack8", words[layer], k),
                                   ("dense", dense[layer], None)):
            kw = dict(layout=layout, logical_k=lk)
            assert torch.equal(plane_gemm.plane_plain(x, planes, **kw), want)
            n0 = plane_gemm.gemm.launches
            assert torch.equal(plane_gemm.gemm(x, planes, **kw), want)
            assert plane_gemm.gemm.launches == n0 + 1
            if b == 1:
                v0 = plane_gemm.gemv.launches
                assert torch.equal(plane_gemm.gemv(x, planes, **kw), want)
                assert plane_gemm.gemv.launches == v0 + 1


@pytest.mark.parametrize("wb", [3, 4, 8])
@pytest.mark.parametrize("n", [200, 2048])
@pytest.mark.parametrize("layout", ["bitpack8", "dense"])
def test_plane_gemm_is_batch_invariant(gen, layout, n, wb):
    """The rows of a 128-row call (tensor cores) equal 17-row (tensor
    cores), 4-row and 1-row calls (dp4a) on the same weights, for a
    compiled plane count and the run-time one."""
    k = 2048
    half = 1 << (wb - 1)
    w = torch.randint(-half, half, (k, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    planes = ref.pack_bitplanes(w, wb)
    if layout == "bitpack8":
        planes = ref.pack_plane_words(planes)
    kw = dict(layout=layout, logical_k=k if layout == "bitpack8" else None)
    x = torch.randint(-127, 128, (128, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    full = plane_gemm.gemm(x, planes, **kw)
    assert torch.equal(full, (x.double() @ w.double()).to(torch.int32))
    for rows in (17, 4):
        for i in range(0, 128, rows):
            assert torch.equal(plane_gemm.gemm(x[i:i + rows], planes, **kw),
                               full[i:i + rows])
    for i in range(128):
        assert torch.equal(plane_gemm.gemv(x[i:i + 1], planes, **kw),
                           full[i:i + 1])


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


@pytest.mark.parametrize("n_fracs", [0, 3])
@pytest.mark.parametrize("shape", [(256, 8, 65536), (16, 8, 4096),
                                   (3, 5, 1000), (1, 8, 77), (1, 8, 65536),
                                   (2, 5, 1001), (4, 8, 1002), (5, 3, 1002),
                                   (70000, 8, 4)])
def test_majx_sense_equals_plain(gen, shape, n_fracs):
    t, r, c = shape
    charge = torch.rand(shape, generator=gen, device="cuda")
    offs = 0.03 * torch.randn(c, generator=gen, device="cuda")
    noise = torch.randn((t, c), generator=gen, device="cuda")
    p = PhysicsParams()
    before = sense.majx_sense.launches
    got = sense.majx_sense(charge, offs, noise, p, n_fracs)
    want = sense.majx_sense_plain(charge, offs, noise, p, n_fracs)
    assert sense.majx_sense.launches == before + 1
    assert torch.equal(got, want)
    assert 0 < float(got.mean()) < 1
    with pytest.raises(ValueError):                  # float64 is not taken
        sense.majx_sense(charge.double(), offs, noise, p, n_fracs)


@pytest.mark.parametrize("shift", [1, 2])
def test_majx_sense_unaligned_pointers(gen, shift):
    """Pointers only 4- or 8-byte aligned: the kernel still equals the
    plain version."""
    t, r, c = 3, 8, 4096
    charge = torch.rand(t * r * c + shift, generator=gen, device="cuda")[
        shift:].view(t, r, c)
    offs = 0.03 * torch.randn(c + shift, generator=gen, device="cuda")
    offs = offs[shift:]
    noise = torch.randn(t * c + shift, generator=gen, device="cuda")[
        shift:].view(t, c)
    p = PhysicsParams()
    got = sense.majx_sense(charge, offs, noise, p, 3)
    assert torch.equal(got, sense.majx_sense_plain(charge, offs, noise, p, 3))


def test_simra_launches_the_sensing_kernel(gen):
    p = PhysicsParams()
    device.set_params(p)
    state = device.make_subarray(gen, 8, 4096, p, device="cuda")
    for r in range(5):
        state = device.write_row(state, r, torch.randint(
            0, 2, (4096,), generator=gen, device="cuda"))
    before = sense.majx_sense.launches
    new, bits = device.simra(state, range(8), gen, 3)
    assert sense.majx_sense.launches == before + 1
    assert bits.shape == (4096,) and torch.equal(new.charge[0], bits)


@pytest.mark.parametrize("b", [1, 8])
def test_ops_dense_entries_launch_the_kernels(gen, b):
    """The reference's default layout through ``ops``: every entry
    launches its kernel on the dense planes and equals the integer
    product."""
    w, window, _, cols, pwb = _window(gen, 2048, 2048, True)
    planes = ref.pack_bitplanes(w, 4)
    x = torch.randint(-127, 128, (b, 2048), generator=gen, device="cuda",
                      dtype=torch.int8)
    want = (x.double() @ w.double()).to(torch.int32)
    counts = [plane_gemm.gemm, plane_gemm.gemv, placed_gemm.gemm_placed,
              placed_gemm.gemv_placed]
    before = [f.launches for f in counts]
    for mode in ("planes", "folded"):
        assert torch.equal(ops.bitplane_gemv(x, planes, mode), want)
        assert torch.equal(ops.bitplane_gemm(x, planes, mode), want)
        assert torch.equal(ops.bitplane_gemv_placed(
            x, window, cols, mode, window_block=pwb), want)
        assert torch.equal(ops.bitplane_gemm_placed(
            x, window, cols, mode, window_block=pwb), want)
    after = [f.launches - n for f, n in zip(counts, before)]
    assert after == ([2, 2, 2, 2] if b == 1 else [4, 0, 4, 0])


# ---- tuned launch plans (kernels/autotune.py) --------------------------

#: the tuning phase's shapes of qwen3-1.7b's packs (wi/wg, wo, wq/attn wo,
#: wk/wv, unembed) at its tuning batches
TUNE_KN = [(2048, 6144), (6144, 2048), (2048, 2048), (2048, 1024),
           (2048, 151936)]


def _tuning_pack(gen, k, n, placed, layout):
    """(planes, col_ids, window_block) of a random 4-bit pack, placed on a
    window with about 6% spare columns per block when ``placed``."""
    from repro_torch.analysis.contracts import synthetic_placed
    w = torch.randint(-8, 8, (k, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    planes = ref.pack_bitplanes(w, 4)
    cols = pwb = None
    if placed:
        bc = ops.largest_divisor(n, ops.N_BLOCK)
        w_len, pwb, ids = synthetic_placed(n, pad=max(8, bc // 16))
        cols = torch.from_numpy(ids).to("cuda")
        window = torch.zeros((4, k, w_len), dtype=torch.int8, device="cuda")
        window[:, :, cols.long()] = planes
        planes = window
    if layout == "bitpack8":
        planes = ref.pack_plane_words(planes)
    return planes, cols, pwb


@pytest.mark.parametrize("layout", ["bitpack8", "dense"])
@pytest.mark.parametrize("placed", [True, False])
@pytest.mark.parametrize("kn", TUNE_KN)
@pytest.mark.parametrize("b", [1, 4, 32])
def test_every_tuning_candidate_equals_plain(gen, b, kn, placed, layout):
    """Every candidate the tuner would time at the tuning phase's shapes
    launches and equals the plain version bit for bit."""
    from repro_torch.kernels.autotune import candidate_plans, valid_candidates
    k, n = kn
    planes, cols, pwb = _tuning_pack(gen, k, n, placed, layout)
    x = torch.randint(-127, 128, (b, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    entry = "gemv" if b == 1 else "gemm"
    lk = k if layout == "bitpack8" else None
    plans = valid_candidates(
        candidate_plans(entry, b, k, n, layout=layout,
                        placed_window=planes.shape[-1] if placed else None,
                        pack_window_block=pwb,
                        sms=torch.cuda.get_device_properties(0)
                        .multi_processor_count),
        entry, x.shape, planes.shape, layout=layout, logical_k=lk,
        col_ids=cols, window_block=pwb,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    assert len(plans) > 1 and plans[0].is_default()
    kw = dict(layout=layout, logical_k=lk)
    if placed:
        fn = placed_gemm.gemv_placed if b == 1 else placed_gemm.gemm_placed
        want = placed_gemm.placed_plain(x, planes, cols, window_block=pwb,
                                        **kw)
        args = (x, planes, cols)
        kw["window_block"] = pwb
    else:
        fn = plane_gemm.gemv if b == 1 else plane_gemm.gemm
        want = plane_gemm.plane_plain(x, planes, **kw)
        args = (x, planes)
    for plan in plans:
        got = fn(*args, tile_plan=None if plan.is_default() else plan, **kw)
        assert torch.equal(got, want), plan


def test_tune_kernel_winner_equals_plain(gen):
    """``tune_kernel`` on the card: the heuristic first, a winner among
    several candidates whose output equals the plain version."""
    from repro_torch.kernels.autotune import tune_kernel
    planes, cols, pwb = _tuning_pack(gen, 2048, 6144, True, "bitpack8")
    x = torch.randint(-127, 128, (4, 2048), generator=gen, device="cuda",
                      dtype=torch.int8)
    res = tune_kernel("gemm", x, planes, col_ids=cols, window_block=pwb,
                      layout="bitpack8", logical_k=2048)
    assert res.key == "gemm__placed__bitpack8__4x2048x6144@4b"
    assert res.n_candidates > 1 and res.tuned_s <= res.heuristic_s
    got = placed_gemm.gemm_placed(
        x, planes, cols, window_block=pwb, logical_k=2048,
        tile_plan=None if res.plan.is_default() else res.plan)
    want = placed_gemm.placed_plain(x, planes, cols, window_block=pwb,
                                    layout="bitpack8", logical_k=2048)
    assert torch.equal(got, want)
