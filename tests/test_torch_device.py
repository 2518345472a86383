"""Parity of the port's command-level subarray simulator and bit-serial
MAJ arithmetic with the JAX package (``repro.pud.device``,
``repro.pud.bitserial``), on the CPU.

Commands are deterministic and held exactly equal to the reference's.
``simra`` draws its sensing noise from a generator (the reference from a
key), so it is compared exactly where the noise cannot matter: at zero
sigma, with nonzero sense offsets.  The adder and multiplier graphs are
exact on an ideal (noise-free, offset-free) device, as the reference's
own tests hold them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.pud import bitserial as jbits  # noqa: E402
from repro.pud import device as jdev  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro_torch.kernels import sense  # noqa: E402
from repro_torch.pud import bitserial, device  # noqa: E402
from repro_torch.pud.physics import NEUTRAL, PhysicsParams  # noqa: E402

ZERO_SIGMA = dict(sigma_dynamic=0.0, sigma_frac=0.0, sigma_transfer=0.0)
IDEAL = PhysicsParams(sigma_static=0.0, **ZERO_SIGMA)


@pytest.fixture
def physics():
    """Set both simulators' physics for one test, then restore defaults."""
    def use(**kw):
        device.set_params(PhysicsParams(**kw))
        jdev.set_params(JPhys(**kw))
    yield use
    device.set_params(PhysicsParams())
    jdev.set_params(JPhys())


def _states(seed, n_rows=10, n_cols=300):
    """The same state in both packages: numpy charges and offsets."""
    rng = np.random.default_rng(seed)
    charge = rng.integers(0, 2, (n_rows, n_cols)).astype(np.float32)
    offs = (0.03 * rng.standard_normal(n_cols)).astype(np.float32)
    port = device.SubarrayState(torch.from_numpy(charge.copy()),
                                torch.from_numpy(offs.copy()))
    ref = jdev.SubarrayState(jnp.asarray(charge), jnp.asarray(offs))
    return port, ref


def _same(port, ref):
    np.testing.assert_array_equal(port.charge.numpy(), np.asarray(ref.charge))
    np.testing.assert_array_equal(port.sense_offset.numpy(),
                                  np.asarray(ref.sense_offset))


def test_commands_equal_reference(physics):
    physics()
    port, ref = _states(0)
    bits = np.random.default_rng(1).integers(0, 2, 300).astype(np.float32)
    before = port.charge.clone()
    port = device.write_row(port, 3, torch.from_numpy(bits))
    ref = jdev.write_row(ref, 3, jnp.asarray(bits))
    _same(port, ref)
    assert not torch.equal(port.charge, before)     # a new state ...
    assert torch.equal(before, _states(0)[0].charge)  # ... the old intact
    port = device.rowcopy(port, 3, (5, 7))
    ref = jdev.rowcopy(ref, 3, (5, 7))
    _same(port, ref)
    for _ in range(4):                                # multi-level charge
        port, ref = device.frac(port, 5), jdev.frac(ref, 5)
        _same(port, ref)
    np.testing.assert_array_equal(device.read_row(port, 5).numpy(),
                                  np.asarray(jdev.read_row(ref, 5)))
    assert port.n_rows == 10 and port.n_cols == 300


def test_make_subarray_draws_from_the_generator():
    p = PhysicsParams()
    a = device.make_subarray(torch.Generator().manual_seed(3), 8, 4096, p,
                             device="cpu")
    b = device.make_subarray(torch.Generator().manual_seed(3), 8, 4096, p,
                             device="cpu")
    assert torch.equal(a.sense_offset, b.sense_offset)
    assert torch.equal(a.charge, torch.full((8, 4096), NEUTRAL))
    assert abs(float(a.sense_offset.std()) - p.sigma_static) < 0.002


@pytest.mark.parametrize("n_fracs", [0, 3])
def test_simra_equals_reference_at_zero_sigma(physics, n_fracs):
    """Zero sensing noise and nonzero offsets: the sensed bits and the
    restored state equal the reference's, whatever the noise draws."""
    physics(**ZERO_SIGMA)
    port, ref = _states(2)
    for r in (5, 6, 7):                  # calibration-like partial charges
        for _ in range(r - 4):
            port, ref = device.frac(port, r), jdev.frac(ref, r)
    before = sense.majx_sense.launches
    port, bits = device.simra(port, range(8), torch.Generator(), n_fracs)
    ref, jbits_ = jdev.simra(ref, range(8), jax.random.key(0), n_fracs)
    assert sense.majx_sense.launches == before      # CPU: the plain version
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits_))
    _same(port, ref)
    assert 0 < float(bits.mean()) < 1                # offsets decide


def test_simra_majority_and_restore(physics):
    physics(**ZERO_SIGMA)
    state = device.make_subarray(torch.Generator(), 16, 256, IDEAL,
                                 device="cpu")
    state = device.SubarrayState(state.charge, torch.zeros(256))
    for r, b in enumerate([1, 1, 1, 0, 0]):
        state = device.write_row(state, r, torch.full((256,), float(b)))
    for r in (5, 6, 7):
        state = device.write_row(state, r, torch.full((256,), NEUTRAL))
    state, out = device.simra(state, range(8), torch.Generator())
    assert torch.equal(out, torch.ones(256))
    assert torch.equal(state.charge[:8], torch.ones(8, 256))


def _ctx(n_cols):
    return bitserial.MajContext(params=IDEAL, sense_offset=torch.zeros(n_cols),
                                calib_charge=torch.full((3, n_cols), NEUTRAL),
                                n_fracs=0)


def test_full_adder_truth_table():
    ctx, gen = _ctx(8), torch.Generator()
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                av, bv, cv = (torch.full((8,), float(v)) for v in (a, b, c))
                s, sb, cout, coutb = bitserial.full_adder(
                    ctx, av, 1 - av, bv, 1 - bv, cv, 1 - cv, gen)
                assert int(s[0]) == (a + b + c) % 2, (a, b, c)
                assert int(cout[0]) == (a + b + c) // 2, (a, b, c)
                assert int(sb[0]) == 1 - (a + b + c) % 2
                assert int(coutb[0]) == 1 - (a + b + c) // 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add8_exact_on_ideal_device(seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 256, (2, 64), dtype=np.int32))
    b = torch.from_numpy(rng.integers(0, 256, (2, 64), dtype=np.int32))
    ab_, bb_ = bitserial.int_to_bits(a, 8), bitserial.int_to_bits(b, 8)
    s, sbar, cout, _ = bitserial.add_n(_ctx(64), ab_, 1 - ab_, bb_, 1 - bb_,
                                       torch.Generator(), want_sum_bar=True)
    got = bitserial.bits_to_int(s) + (cout.to(torch.int32) << 8)
    assert torch.equal(got, a + b)
    assert torch.equal(sbar, 1 - s)


def test_mul8_truncated_exact_on_ideal_device():
    rng = np.random.default_rng(123)
    a = torch.from_numpy(rng.integers(0, 256, (2, 32), dtype=np.int32))
    b = torch.from_numpy(rng.integers(0, 256, (2, 32), dtype=np.int32))
    ab_, bb_ = bitserial.int_to_bits(a, 8), bitserial.int_to_bits(b, 8)
    s = bitserial.mul8_truncated(_ctx(32), ab_, 1 - ab_, bb_, 1 - bb_,
                                 torch.Generator())
    assert torch.equal(bitserial.bits_to_int(s), (a * b) & 0xFF)


def test_graphs_equal_reference_at_zero_sigma_with_offsets():
    """Nonzero offsets and the B_{3,0,0} rows at zero sigma: the sum and
    product bits of every column equal the reference's, errors included."""
    rng = np.random.default_rng(4)
    n = 256
    offs = (0.033 * rng.standard_normal(n)).astype(np.float32)
    calib = np.stack([np.full(n, 0.5 + 0.5 * 0.418438 ** 3, np.float32),
                      np.zeros(n, np.float32), np.ones(n, np.float32)])
    a = rng.integers(0, 256, (4, n), dtype=np.int32)
    b = rng.integers(0, 256, (4, n), dtype=np.int32)
    p, jp = PhysicsParams(**ZERO_SIGMA), JPhys(**ZERO_SIGMA)
    ctx = bitserial.MajContext(p, torch.from_numpy(offs),
                               torch.from_numpy(calib), 3)
    jctx = jbits.MajContext(jp, jnp.asarray(offs), jnp.asarray(calib), 3)
    ta, tb = (bitserial.int_to_bits(torch.from_numpy(v), 8) for v in (a, b))
    ja, jb = (jbits.int_to_bits(jnp.asarray(v), 8) for v in (a, b))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    s, _, cout, _ = bitserial.add_n(ctx, ta, 1 - ta, tb, 1 - tb,
                                    torch.Generator())
    js, _, jcout, _ = jbits.add_n(jctx, ja, 1 - ja, jb, 1 - jb,
                                  jax.random.key(0))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(cout.numpy(), np.asarray(jcout))
    m = bitserial.mul8_truncated(ctx, ta, 1 - ta, tb, 1 - tb,
                                 torch.Generator())
    jm = jbits.mul8_truncated(jctx, ja, 1 - ja, jb, 1 - jb, jax.random.key(1))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    got = bitserial.bits_to_int(m).numpy()
    assert 0 < (got != (a * b) & 0xFF).mean() < 1    # offsets cause errors


def test_int_bits_roundtrip_equals_reference():
    x = torch.arange(256, dtype=torch.int32)
    bits = bitserial.int_to_bits(x, 8)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(jbits.int_to_bits(jnp.arange(256), 8)))
    assert torch.equal(bitserial.bits_to_int(bits), x)
    assert bitserial.bits_to_int(bits).dtype == torch.int32
