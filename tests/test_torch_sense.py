"""Parity of the port's SiMRA sensing (``majx_sense``) and of the kernel
entries of ``kernels/ops`` with the JAX package, on the CPU through the
plain versions.

Every comparison is exact.  The plain ``majx_sense`` equals the reference's
eager oracle bit for bit (the same float32 operations in the same order,
rows summed in row order).  Against the Pallas kernel in interpret mode it
is held equal where that kernel agrees with its own oracle: under ``jit``
XLA divides by a reciprocal (ROADMAP Queue 3), and the columns where that
flips a bit are counted exactly (none on these draws).  The dense-layout
GEMM entries compute integers, so they equal the reference's entries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro_torch.core.fleet import FleetConfig, ladder_tables  # noqa: E402
from repro_torch.kernels import ops, ref, sense  # noqa: E402
from repro_torch.kernels.calib_iter import calib_iter  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402

P, JP = PhysicsParams(), JPhys()
SHAPES = [(8, 8, 1024), (16, 8, 2048), (8, 4, 1024), (32, 8, 1024)]


def _sense_inputs(seed, t, r, c):
    rng = np.random.default_rng(seed)
    charge = rng.random((t, r, c), dtype=np.float32)
    offs = (0.03 * rng.standard_normal(c)).astype(np.float32)
    noise = rng.standard_normal((t, c)).astype(np.float32)
    return charge, offs, noise


def _port_sense(charge, offs, noise, n_fracs, params=P):
    return ops.majx_sense(torch.from_numpy(charge), torch.from_numpy(offs),
                          torch.from_numpy(noise), params, n_fracs).numpy()


@pytest.mark.parametrize("n_fracs", [0, 3])
@pytest.mark.parametrize("t,r,c", SHAPES)
def test_plain_equals_eager_oracle(t, r, c, n_fracs):
    charge, offs, noise = _sense_inputs(t * r + c, t, r, c)
    got = _port_sense(charge, offs, noise, n_fracs)
    want = np.asarray(jref.majx_sense_ref(
        jnp.asarray(charge), jnp.asarray(offs), jnp.asarray(noise), JP,
        n_fracs))
    assert got.dtype == np.float32 and got.shape == (t, c)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


@pytest.mark.parametrize("n_fracs", [0, 3])
@pytest.mark.parametrize("t,r,c", SHAPES)
def test_plain_equals_pallas_kernel(t, r, c, n_fracs):
    """Equal to the Pallas kernel (interpret mode) wherever the kernel
    agrees with its eager oracle; the disagreeing bits are counted."""
    charge, offs, noise = _sense_inputs(7 + t + c, t, r, c)
    jargs = (jnp.asarray(charge), jnp.asarray(offs), jnp.asarray(noise), JP,
             n_fracs)
    kern = np.asarray(jops.majx_sense(*jargs, interpret=True))
    eager = np.asarray(jref.majx_sense_ref(*jargs))
    agree = kern == eager
    assert int((~agree).sum()) == 0
    got = _port_sense(charge, offs, noise, n_fracs)
    np.testing.assert_array_equal(got[agree], kern[agree])


def test_majority_semantics():
    """With zero offsets and noise, a SiMRA of k full and (5 - k) empty
    data rows plus three neutral rows is a majority vote over the 5 data
    rows (the reference's own case)."""
    c = 1024
    params = PhysicsParams(sigma_dynamic=0.0, sigma_frac=0.0,
                           sigma_transfer=0.0)
    rows = [[1.0] * k + [0.0] * (5 - k) + [0.5] * 3 for k in range(6)]
    charge = torch.tensor(rows, dtype=torch.float32)[:, :, None].expand(
        6, 8, c).contiguous()
    out = ops.majx_sense(charge, torch.zeros(c), torch.zeros((6, c)), params,
                         0)
    assert torch.equal(out[:, 0], torch.tensor([0, 0, 0, 1, 1, 1.0]))
    assert torch.equal(out, out[:, :1].expand(6, c))


def test_cpu_tensors_never_launch():
    before = sense.majx_sense.launches
    charge, offs, noise = _sense_inputs(0, 3, 8, 100)    # ragged shape
    got = _port_sense(charge, offs, noise, 3)
    assert sense.majx_sense.launches == before
    want = ref.majx_sense_ref(torch.from_numpy(charge), torch.from_numpy(offs),
                              torch.from_numpy(noise), P, 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_ops_calib_iter_fused_takes_float_bits():
    """The reference passes operand bits as float32; the port's entry
    takes them as it does and equals the kernel wrapper on uint8 bits."""
    rng = np.random.default_rng(1)
    ladder = FleetConfig().ladder(P)
    qsum, swing = ladder_tables(ladder, P)
    bits = rng.integers(0, 2, (64, 5, 300), dtype=np.uint8)
    noise = torch.from_numpy(rng.standard_normal((64, 300)).astype(
        np.float32))
    levels = torch.from_numpy(rng.integers(0, ladder.n_levels, 300,
                                           dtype=np.int32))
    offs = torch.from_numpy((0.033 * rng.standard_normal(300)).astype(
        np.float32))
    args = (P, ladder.n_fracs, qsum, swing, 0.0009, 5)
    got = ops.calib_iter_fused(torch.from_numpy(bits).float(), noise, levels,
                               offs, *args)
    want = calib_iter(torch.from_numpy(bits), noise, levels, offs, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The GEMM entries of ops in the dense plane layout (the reference's default)
# ---------------------------------------------------------------------------

GEMV_SHAPES = [(1, 256, 256), (4, 512, 256), (8, 256, 512), (2, 1024, 1024)]


def _dense(seed, b, k, n, wb=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, k), dtype=np.int64).astype(np.int8)
    w = rng.integers(-(1 << (wb - 1)), 1 << (wb - 1), (k, n), dtype=np.int32)
    planes = np.array(jref.pack_bitplanes(jnp.asarray(w), wb))
    # a block-aligned window: N in blocks of 128 columns, each placed among
    # 160 window columns
    bc, pwb = 128, 160
    col_ids = np.concatenate([j * pwb + rng.permutation(pwb)[:bc]
                              for j in range(n // bc)]).astype(np.int32)
    window = np.zeros((wb, k, (n // bc) * pwb), np.int8)
    window[:, :, col_ids] = planes
    return x, w, planes, window, col_ids, pwb


@pytest.mark.parametrize("mode", ["planes", "folded"])
@pytest.mark.parametrize("b,k,n", GEMV_SHAPES)
def test_dense_entries_equal_reference(b, k, n, mode):
    x, w, planes, window, col_ids, pwb = _dense(b + k + n, b, k, n)
    want = x.astype(np.int64) @ w.astype(np.int64)
    jx, jp, jw, jc = map(jnp.asarray, (x, planes, window, col_ids))
    tx, tp, tw, tc = map(torch.from_numpy, (x, planes, window, col_ids))
    pairs = [
        (ops.bitplane_gemv(tx, tp, mode),
         jops.bitplane_gemv(jx, jp, mode, interpret=True)),
        (ops.bitplane_gemm(tx, tp, mode),
         jops.bitplane_gemm(jx, jp, mode, interpret=True)),
        (ops.bitplane_gemv_placed(tx, tw, tc, mode, window_block=pwb),
         jops.bitplane_gemv_placed(jx, jw, jc, mode, interpret=True,
                                   window_block=pwb)),
        (ops.bitplane_gemm_placed(tx, tw, tc, mode, window_block=pwb),
         jops.bitplane_gemm_placed(jx, jw, jc, mode, interpret=True,
                                   window_block=pwb)),
    ]
    for got, ref_out in pairs:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_out))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("placed", [False, True])
def test_pud_gemv_dense_equals_reference(placed):
    """``pud_gemv`` on dense planes, a [K] and a [B, K] input, bit-equal to
    the reference's on its oracle backend for float32 activations."""
    x8, w, planes, window, col_ids, pwb = _dense(5, 1, 256, 256)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    scale = (0.01 + rng.random(256)).astype(np.float32)
    kw, jkw = {}, {}
    p = planes
    if placed:
        p = window
        kw = dict(col_ids=torch.from_numpy(col_ids), window_block=pwb)
        jkw = dict(col_ids=jnp.asarray(col_ids), window_block=pwb)
    for xi in (x, x[0]):
        got = ops.pud_gemv(torch.from_numpy(xi), torch.from_numpy(p),
                           torch.from_numpy(scale), **kw)
        want = jops.pud_gemv(jnp.asarray(xi), jnp.asarray(p),
                             jnp.asarray(scale), backend="reference", **jkw)
        assert got.shape == xi.shape[:-1] + (256,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The launch plan of csrc/simra_sense.cu
# ---------------------------------------------------------------------------

def _covered(plan, t, c):
    """How often the plan's grid visits each (event, column), as the
    kernel walks it: block (x, y), thread i takes column x * threads + i
    (if below C) and events y, y + grid_y, ..."""
    gx, gy = plan.grid
    col = np.arange(gx * plan.threads)
    hits = np.zeros((t, c), dtype=np.int64)
    for y in range(gy):
        hits[y::gy] += np.bincount(col[col < c], minlength=c)
    return hits


@pytest.mark.parametrize("t, c", [(1, 65536), (256, 65536), (16, 4096),
                                  (13, 65000), (3, 77), (1, 1), (5, 257)])
def test_plan_covers_every_event_and_column_once(t, c):
    plan = sense.plan_launch(t, c)
    assert (_covered(plan, t, c) == 1).all()


def test_plan_keeps_a_block_per_sm_for_one_event():
    """The simulator's launch (one event of a 65,536-column subarray) has
    at least one block for each of the H100's 132 SMs."""
    plan = sense.plan_launch(1, 65536)
    assert plan.grid[0] * plan.grid[1] >= 132
    assert plan.threads == sense.THREADS and plan.threads % 32 == 0


def test_plan_strides_events_past_the_grid_limit():
    """More events than a grid row count: blocks stride over them, and
    every event is still visited once."""
    t = sense.MAX_GRID_Y + 4465
    plan = sense.plan_launch(t, 4)
    assert plan.grid == (1, sense.MAX_GRID_Y)
    assert (_covered(plan, t, 4) == 1).all()
    assert plan.c_array()[:] == [plan.threads, *plan.grid]
