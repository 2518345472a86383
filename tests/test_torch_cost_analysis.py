"""The dry run's cost counter (``repro_torch/launch/cost_analysis.py``)
against known graphs (the counterparts of ``tests/test_hlo_analysis.py``)
and against the reference's HLO analyzer on the jitted smoke steps.

FLOPs are matrix products (and, in the port, convolutions).  Prefill and
decode equal the reference's count.  Training is held within
``TRAIN_RTOL`` on matrix products: the port's rematerialised forward
(``torch.utils.checkpoint``) runs a product whose output is dead in the
backward where XLA drops it -- the shared experts' output projection
before the MoE aux-loss terms, the hybrid's shared-block FFN output
projection before its LoRA terms -- and the reference's three-operand SSD
einsums lower to one more dot_general (an elementwise product with K = 1)
that the port computes as a multiply.  Convolutions are held to the
formula: the reference's gradient-conv heuristic miscounts at smoke size
(ROADMAP Queue 3).
"""
import _torch_cpu  # noqa: F401
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get as j_get
from repro.launch import hlo_analysis
from repro.models.params import abstract_params as j_abstract
from repro.runtime import optim as j_optim
from repro.runtime import steps as j_steps
from repro_torch.configs import all_archs, get
from repro_torch.launch.cost_analysis import CostMode, analyze, conv_flops
from repro_torch.models.params import abstract_params
from repro_torch.runtime import steps

B, S = 2, 64
TRAIN_RTOL = 0.05


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Known graphs
# ---------------------------------------------------------------------------

def test_single_matmul_flops():
    c, _, _ = analyze(lambda a, b: a @ b, meta(512, 256), meta(256, 128))
    assert c.flops == 2 * 512 * 256 * 128


def test_loop_counts_every_iteration():
    """The reference multiplies a scan body by its trip count; an eager
    loop runs every iteration, and each is counted."""
    def looped(a, w):
        for _ in range(9):
            a = a @ w
        return a
    c, _, _ = analyze(looped, meta(256, 256), meta(256, 256))
    assert c.flops == 9 * 2 * 256 ** 3


def test_nested_loops():
    def nested(a, w):
        for _ in range(5):
            for _ in range(3):
                a = a @ w
        return a
    c, _, _ = analyze(nested, meta(128, 128), meta(128, 128))
    assert c.flops == 15 * 2 * 128 ** 3


def test_batched_einsum_flops():
    c, _, _ = analyze(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                      meta(8, 64, 32), meta(8, 32, 16))
    assert c.flops == 2 * 8 * 64 * 32 * 16


def test_repeat_multiplies_counts_not_peak():
    a, w = meta(64, 64), meta(64, 64)
    with CostMode() as cm, cm.repeat(4):
        a @ w
    assert cm.cost.flops == 4 * 2 * 64 ** 3
    assert cm.peak == 64 * 64 * 4


def test_bytes_nonzero_and_scale():
    n = 1024 * 1024 * 4
    c, peak, _ = analyze(lambda a: torch.tanh(a) + 1.0, meta(1024, 1024))
    assert n <= c.bytes <= 6 * n
    assert c.bytes == 4 * n           # tanh: in + out; add: in + out
    assert peak == 2 * n


def test_views_count_nothing():
    c, peak, _ = analyze(lambda a: a.reshape(-1)[:10].view(2, 5).t(),
                         meta(4, 8))
    assert c.bytes == 0 and c.flops == 0 and peak == 0


def test_peak_live_bytes_of_a_known_graph():
    """x resident (n); tanh (n, saved), y = 2 tanh (n, held), the grad of
    the product (n), tanh's backward (n, becomes x.grad): peak 5 n; after,
    x and x.grad."""
    n = 1024 * 1024 * 4
    x = meta(1024, 1024).requires_grad_()
    with CostMode(resident=n) as cm:
        y = torch.tanh(x) * 2
        y.sum().backward()
        del y
    assert cm.peak == 5 * n + 4 + 4     # + the 0-d sum and its grad
    assert cm.live == 2 * n


def test_conv_flops_forward_and_backward():
    """Depthwise conv1d (the Mamba2 conv): forward 2 x out x window x
    (in / groups); backward that once per gradient computed."""
    c_, w_ = 24, 4
    x = meta(2, c_, 35).requires_grad_()
    w = meta(c_, 1, w_).requires_grad_()
    fwd = conv_flops(2 * c_ * 32, w.shape)
    assert fwd == 2 * 2 * c_ * 32 * w_
    with CostMode() as cm:
        y = torch.nn.functional.conv1d(x, w, groups=c_)
    assert cm.cost.flops == fwd
    with CostMode() as cm:
        y.sum().backward()
    assert cm.cost.flops == 2 * fwd
    with CostMode() as cm:
        y2 = torch.nn.functional.conv1d(x.detach(), w, groups=c_)
        y2.sum().backward()             # the weight's gradient only
    assert cm.cost.flops == 2 * fwd


# ---------------------------------------------------------------------------
# Against the reference's analyzer on the smoke models
# ---------------------------------------------------------------------------

def _extras(arch, model, jax_side: bool):
    fam, c = get(arch).family, model.cfg
    shapes = {}
    if fam == "vlm":
        shapes["patches"] = (B, c.n_patches, c.d_vit)
    if fam == "encdec":
        shapes["frames"] = (B, c.n_frames, c.d_model)
    if jax_side:
        return {k: jax.ShapeDtypeStruct(v, jnp.bfloat16)
                for k, v in shapes.items()}
    return {k: meta(*v, dtype=torch.bfloat16) for k, v in shapes.items()}


def _matmul_flops(cm: CostMode) -> float:
    return cm.cost.flops - sum(v[1] for k, v in cm.by_op.items()
                               if "convolution" in k)


@pytest.fixture
def ref_dots(monkeypatch):
    """The reference's analyzer on matrix products only (its convolution
    count zeroed for this test)."""
    monkeypatch.setattr(hlo_analysis, "_conv_flops", lambda op, comp: 0.0)

    def count(fn, *args):
        return hlo_analysis.analyze(
            jax.jit(fn).lower(*args).compile().as_text()).flops
    return count


def _pair(arch):
    jm, m = j_get(arch).make_smoke(), get(arch).make_smoke()
    return jm, j_abstract(jm.param_defs()), m, abstract_params(
        m.param_defs())


@pytest.mark.parametrize("arch", all_archs())
def test_prefill_and_decode_flops_equal_the_reference(arch, ref_dots):
    jm, jp, m, p = _pair(arch)
    fam = get(arch).family
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    jex = _extras(arch, jm, True)
    want = ref_dots(j_steps.make_prefill_step(jm, fam), jp, tok, jex or None)
    with CostMode() as cm, torch.no_grad():
        steps.make_prefill_step(m, fam)(p, meta(B, S, dtype=torch.int32),
                                        _extras(arch, m, False) or None)
    assert _matmul_flops(cm) == want

    want = ref_dots(j_steps.make_decode_step(jm), jp,
                    j_abstract(jm.cache_defs(B, S)),
                    jax.ShapeDtypeStruct((B, 1), jnp.int32),
                    jax.ShapeDtypeStruct((), jnp.int32))
    with CostMode() as cm, torch.no_grad():
        steps.make_decode_step(m)(p, abstract_params(m.cache_defs(B, S)),
                                  meta(B, 1, dtype=torch.int32), S - 1)
    assert _matmul_flops(cm) == want


@pytest.mark.parametrize("arch", all_archs())
def test_train_matmul_flops_within_tolerance_of_the_reference(arch,
                                                               ref_dots):
    jm, jp, m, p = _pair(arch)
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    oc = j_optim.OptConfig()
    state = jax.eval_shape(lambda q: j_optim.init_opt_state(q, oc), jp)
    want = ref_dots(j_steps.make_train_step(jm, oc), jp, state,
                    {"tokens": tok, "labels": tok,
                     **_extras(arch, jm, True)},
                    jax.ShapeDtypeStruct((), jnp.uint32))
    ttok = meta(B, S, dtype=torch.int32)
    with CostMode() as cm:
        steps.microbatch_grads(m, p, {"tokens": ttok, "labels": ttok,
                                      **_extras(arch, m, False)}, 1)
    got = _matmul_flops(cm)
    assert abs(got / want - 1) <= TRAIN_RTOL, (got, want)
    if get(arch).family in ("dense", "vlm", "encdec"):
        assert got == want


@pytest.mark.parametrize("arch, fwd_calls, bwd_calls",
                         [("mamba2-1.3b", 6, 3), ("zamba2-7b", 27, 9)])
def test_ssm_conv_flops_follow_the_formula(arch, fwd_calls, bwd_calls):
    """Every Mamba2 block's depthwise conv: forward 2 B S C W, its
    backward twice that.  mamba2 runs each block's forward twice (remat);
    zamba2's segment blocks three times (the segment's remat and the
    block's, nested as in the reference)."""
    m = get(arch).make_smoke()
    ssm = getattr(m, "ssm", None) or m.cfg.ssm_config()
    fwd = 2 * B * S * ssm.conv_channels * ssm.d_conv
    p = abstract_params(m.param_defs())
    ttok = meta(B, S, dtype=torch.int32)
    with CostMode() as cm:
        steps.microbatch_grads(m, p, {"tokens": ttok, "labels": ttok}, 1)
    conv, back = (cm.by_op["aten.convolution.default"],
                  cm.by_op["aten.convolution_backward.default"])
    assert (conv[0], back[0]) == (fwd_calls, bwd_calls)
    assert conv[1] == fwd_calls * fwd and back[1] == bwd_calls * 2 * fwd
