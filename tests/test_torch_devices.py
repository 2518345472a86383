"""Every kernel launch of the port runs on the device of its tensors.

Each of the four ctypes wrappers (unplaced and placed GEMM, sensing,
calibration) enters ``torch.cuda.device`` with its tensor's device around
the launch, and the GEMM plans take that device's SM count.  On the CPU
this is shown with a stand-in for the CUDA runtime and the kernel library;
the GPU case runs on a second card and skips below two devices.
"""
import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro_torch import devices  # noqa: E402
from repro_torch.core.fleet import FleetConfig, ladder_tables  # noqa: E402
from repro_torch.kernels import (build, calib_iter, placed_gemm,  # noqa: E402
                                 plane_gemm, ref, sense)
from repro_torch.pud.physics import PhysicsParams  # noqa: E402


class _Runtime:
    """Stands in for ``torch.cuda.device`` and the kernel libraries: it
    records each device made current and the device current at each
    launch, with the launch's arguments."""

    def __init__(self):
        self.current = None
        self.entered = []
        self.launches = []

    @contextlib.contextmanager
    def device(self, dev):
        prev, self.current = self.current, torch.device(dev)
        self.entered.append(self.current)
        try:
            yield
        finally:
            self.current = prev

    def load(self, name):
        rt = self

        class _Fn:
            argtypes = None
            restype = None

            def __call__(self, *args):
                rt.launches.append((name, rt.current, args))
                return 0

        return types.SimpleNamespace(**{e: _Fn() for e in (
            "plane_gemm_launch", "plane_gemv_launch", "placed_gemm_launch",
            "placed_gemv_launch", "simra_sense_launch", "calib_iter_launch")})


@pytest.fixture
def runtime(monkeypatch):
    rt = _Runtime()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.cuda, "device", rt.device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(build, "load", rt.load)
    monkeypatch.setattr(devices, "sm_count", lambda dev: 16)
    return rt


def _gemm_operands(b, k=64, n=200):
    rng = np.random.default_rng(b)
    w = torch.from_numpy(rng.integers(-8, 8, (k, n), dtype=np.int32))
    words = ref.pack_plane_words(ref.pack_bitplanes(w, 4))
    x = torch.from_numpy(rng.integers(-127, 128, (b, k)).astype(np.int8))
    return x, words


def _calib_args(lead=(), s=8, c=32):
    p = PhysicsParams()
    ladder = FleetConfig().ladder(p)
    qsum, swing = ladder_tables(ladder, p)
    g = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, lead + (s, 5, c), generator=g,
                         dtype=torch.uint8)
    noise = torch.randn(lead + (s, c), generator=g)
    levels = torch.randint(0, ladder.n_levels, lead + (c,), generator=g,
                           dtype=torch.int32)
    offs = 0.033 * torch.randn(lead + (c,), generator=g)
    return (bits, noise, levels, offs,
            p, ladder.n_fracs, qsum, swing, 0.0009, 5)


def _sense_args(t=3, r=8, c=40):
    g = torch.Generator().manual_seed(1)
    return (torch.rand((t, r, c), generator=g),
            0.03 * torch.randn(c, generator=g), torch.randn((t, c),
                                                            generator=g),
            PhysicsParams(), 3)


def _calls():
    """(library, call) of each wrapper's launch, on CPU tensors."""
    x4, words = _gemm_operands(4)
    x128, _ = _gemm_operands(128)
    cols = torch.arange(200, dtype=torch.int32)
    return [
        ("plane_gemm", lambda: plane_gemm.gemm(x4, words, logical_k=64)),
        ("plane_gemm", lambda: plane_gemm.gemm(x128, words, logical_k=64)),
        ("plane_gemm", lambda: plane_gemm.gemv(x4[:1].contiguous(), words,
                                               logical_k=64)),
        ("placed_gemm", lambda: placed_gemm.gemm_placed(x4, words, cols,
                                                        logical_k=64)),
        ("placed_gemm", lambda: placed_gemm.gemv_placed(
            x4[:1].contiguous(), words, cols, logical_k=64)),
        ("simra_sense", lambda: sense.majx_sense(*_sense_args())),
        ("calib_iter", lambda: calib_iter.calib_iter(*_calib_args())),
    ]


@pytest.mark.parametrize("i", range(7))
def test_each_wrapper_launches_under_its_tensor_device(runtime, i):
    lib, call = _calls()[i]
    call()
    assert runtime.entered == [torch.device("cpu")]
    ((name, current, _),) = runtime.launches
    assert name == lib and current == torch.device("cpu")


@pytest.mark.parametrize("b", [1, 4, 128])
def test_plane_plan_takes_the_device_sm_count(runtime, b):
    """The plan passed to the kernel is made for the tensor's device's SM
    count (16 here), not the H100's 132."""
    x, words = _gemm_operands(b, k=2048, n=2048)
    (plane_gemm.gemv if b == 1 else plane_gemm.gemm)(x, words,
                                                     logical_k=2048)
    ((_, _, args),) = runtime.launches
    want = plane_gemm.plan_launch(b, 256, 2048, 4, False, 16)
    assert list(args[-3]) == list(want.c_array())
    assert list(args[-3]) != list(plane_gemm.plan_launch(
        b, 256, 2048, 4, False, 132).c_array())


def test_placed_plan_takes_the_device_sm_count(runtime):
    x, words = _gemm_operands(4, k=2048, n=2048)
    cols = torch.arange(2048, dtype=torch.int32)
    placed_gemm.gemm_placed(x, words, cols, logical_k=2048)
    ((_, _, args),) = runtime.launches
    want = placed_gemm.plan_launch(4, 256, 2048, 4, 2048, 2048, False, 16)
    assert list(args[-3]) == list(want.c_array())
    assert want != placed_gemm.plan_launch(4, 256, 2048, 4, 2048, 2048,
                                           False)


def test_sm_count_is_read_once_per_device(monkeypatch):
    reads = []

    def props(index):
        reads.append(index)
        return types.SimpleNamespace(multi_processor_count=100 + index)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    devices._sm_count.cache_clear()
    try:
        assert devices.sm_count(torch.device("cuda", 1)) == 101
        assert devices.sm_count(torch.device("cuda", 0)) == 100
        assert devices.sm_count(torch.device("cuda", 1)) == 101
        assert reads == [1, 0]
    finally:
        devices._sm_count.cache_clear()


@pytest.mark.gpu
def test_launches_follow_the_tensor_device_on_a_second_card():
    """Tensors on cuda:1 with cuda:0 current: every kernel runs on cuda:1,
    equals its plain version there, and leaves cuda:0 current."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    x4, words = _gemm_operands(4, k=2048, n=2048)
    x128, _ = _gemm_operands(128, k=2048, n=2048)
    x4, x128, words = x4.to(dev), x128.to(dev), words.to(dev)
    cols = torch.arange(2048, dtype=torch.int32, device=dev)
    for x in (x4[:1].contiguous(), x4, x128):
        want = plane_gemm.plane_plain(x, words, layout="bitpack8",
                                      logical_k=2048)
        entry = plane_gemm.gemv if x.shape[0] == 1 else plane_gemm.gemm
        assert torch.equal(entry(x, words, logical_k=2048), want)
        assert torch.equal(placed_gemm.gemm_placed(x, words, cols,
                                                   logical_k=2048), want)
    args = [a.to(dev) if torch.is_tensor(a) else a for a in _sense_args()]
    assert torch.equal(sense.majx_sense(*args), sense.majx_sense_plain(*args))
    args = [a.to(dev) if torch.is_tensor(a) else a for a in _calib_args()]
    got, want = calib_iter.calib_iter(*args), calib_iter.calib_iter_plain(
        *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0


@pytest.mark.gpu
def test_fleet_shards_on_two_cards_equal_one_card():
    """A sharded pack with its shards on cuda:0 and cuda:1 gives the same
    floats as with both on cuda:0, and the mesh path of calibrate_fleet
    split over the two cards equals the single-card run."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import calibrate_fleet, manufacture_fleet
    from repro_torch.kernels.ops import pud_matmul_sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.pud.packer import pack_linear_sharded
    g = torch.Generator().manual_seed(0)
    w = torch.randn((2048, 6144), generator=g).to(torch.bfloat16)
    x = torch.randn((4, 2048), generator=g)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    one = pack_linear_sharded(w.to(c0), 2, devices=[c0, c0])
    two = pack_linear_sharded(w.to(c0), 2, devices=[c0, c1])
    assert two.shards[1].planes.device == c1
    for rows in (x[:1], x):
        got = pud_matmul_sharded(rows.to(c0), two)
        assert got.device == c0
        assert torch.equal(got, pud_matmul_sharded(rows.to(c0), one))
    cfg = FleetConfig(n_channels=1, n_banks=1, n_subarrays=4, n_cols=4096)
    p, cal = PhysicsParams(), CalibrationConfig(n_iterations=3)
    offs = manufacture_fleet(1, cfg, p, device=c0)
    single = calibrate_fleet(1, offs, cfg, p, cal)
    split = calibrate_fleet(1, offs, cfg, p, cal,
                            mesh=make_host_mesh(1, 2, device="cuda"))
    assert torch.equal(split.levels, single.levels)
    assert torch.equal(split.mean_abs_bias, single.mean_abs_bias)
