"""Parity of the port's zamba2-style hybrid (``models/hybrid.py``) with the
JAX package: Mamba2 segments around one shared attention + FFN block with
a per-use LoRA, a Mamba2 tail, 13 KV caches over the same weights.

The full config (81 blocks, 5.75 B parameters) is compared by its
parameter definitions only.  The smoke model (12 blocks: 3 uses of the
shared block after 3 Mamba2 blocks each, no tail) runs in both packages
on the reference's weights (``from_numpy``), with the LoRA's ``ffn_b``
(zeros at init), the SSM's ``a_log`` / ``dt_bias`` / ``d_skip`` and the
RMSNorm scales redrawn N(0, 0.5).

Tolerances:
  * float32: logits within 1e-4 of the reference's jitted model, prefill
    and four chained decode steps (measured at most 2.2e-5, seeds 0-3).
  * bf16: within 0.05 plus one bf16 ulp of the reference run op by op
    (``jax.disable_jit``; measured 0.0078 on the prefill, 0 on the decode
    steps).  The op-by-op run needs a non-empty tail (JAX cannot scan a
    zero-length stack op by op), so this case uses 13 blocks (one tail
    block).  The jitted reference is not the yardstick: XLA fuses bf16
    operations with float32 excess precision, and the hybrid smoke model
    amplifies such ulps to 0.1-0.3 in its logits.
  * the packed path (shared attention + unembed): the reference's packed
    names and placed columns exactly; logits within 0.1 of the op-by-op
    reference teacher-forced, greedy tokens up to its first near-tie.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _families import (check_packed_decode, leaves, pair,  # noqa: E402
                       placed_pair, teacher_forced)
from repro.configs import get as j_get  # noqa: E402
from repro.models.params import param_count as j_count  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models.params import init_params, param_count  # noqa: E402
from repro_torch.runtime.engine import (ServingEngine,  # noqa: E402
                                        engine_refusal)

ARCH = "zamba2-7b"
B, S, GEN = 2, 21, 4
MAX_LEN = S + GEN + 1
ATOL_F32, ATOL_BF16, RTOL_BF16 = 1e-4, 0.05, 2 ** -7


@pytest.mark.parametrize("preset", ["full", "smoke"])
def test_param_defs_match_reference(preset):
    """The doubly stacked ``segments`` tree ([uses, per_segment, ...]
    Mamba2 blocks, a [uses, ...] LoRA), the shared block and the tail:
    the same leaves, shapes, axes, inits, dtypes and counts, and the
    cache's leaves."""
    js, spec = j_get(ARCH), get(ARCH)
    jm = js.make_model() if preset == "full" else js.make_smoke()
    m = spec.make_model() if preset == "full" else spec.make_smoke()
    jl, tl = dict(leaves(jm.param_defs())), dict(leaves(m.param_defs()))
    assert sorted(jl) == sorted(tl)
    for path, d in tl.items():
        assert (d.shape, d.axes, d.init) == \
            (jl[path].shape, jl[path].axes, jl[path].init), path
        assert str(d.dtype).split(".")[-1] == \
            jnp.dtype(jl[path].dtype).name, path
    assert param_count(m.param_defs()) == j_count(jm.param_defs())
    jc, tc = dict(leaves(jm.cache_defs(2, 9))), \
        dict(leaves(m.cache_defs(2, 9)))
    assert {p: (d.shape, d.axes) for p, d in tc.items()} == \
        {p: (d.shape, d.axes) for p, d in jc.items()}
    c = m.cfg
    assert (c.n_shared_uses, c.mamba_per_segment, c.n_tail) == \
        (jm.cfg.n_shared_uses, jm.cfg.mamba_per_segment, jm.cfg.n_tail)
    if preset == "full":
        assert (c.n_shared_uses, c.mamba_per_segment, c.n_tail) == (13, 5, 3)
        assert tl[("segments", "mamba", "mamba", "wx")].shape == \
            (13, 5, 3584, 7168)
        assert param_count(m.param_defs()) == 5_751_829_312


def test_nested_stack_init_and_from_numpy():
    """``init_params`` and ``from_numpy`` keep the doubly stacked tree: the
    reference's smoke tree carried across has the port's init shapes and
    dtypes, leaf for leaf."""
    model = get(ARCH).make_smoke()
    mine = dict(leaves(init_params(model.param_defs(), 0, "cpu")))
    _, _, _, theirs = pair(ARCH)
    theirs = dict(leaves(theirs))
    assert sorted(mine) == sorted(theirs)
    for path, t in mine.items():
        assert (t.shape, t.dtype) == (theirs[path].shape,
                                      theirs[path].dtype), path
    assert mine[("segments", "mamba", "ln", "scale")].shape == (3, 3, 64)


@pytest.mark.parametrize("seed", [0, 1])
def test_smoke_float32_prefill_decode(seed):
    """float32: prefill and four chained decode steps; the shared block's
    13-way (here 3-way) KV caches and the Mamba2 states."""
    jmodel, jparams, model, params = pair(ARCH, seed, f32=True)
    rng = np.random.default_rng(5 + seed)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, cache, jc = teacher_forced(jmodel, jparams, model, params, toks,
                                    feed, MAX_LEN)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_F32)
    jl = dict(leaves(jax.tree.map(np.asarray, jc)))
    for path, leaf in leaves(cache):
        np.testing.assert_allclose(leaf.numpy(), jl[path], rtol=0,
                                   atol=ATOL_F32, err_msg=str(path))


def test_smoke_bf16_near_reference_op_by_op():
    """bf16 on 13 blocks (a one-block tail): prefill and four decode steps
    within 0.05 + one ulp of the reference run op by op."""
    jmodel, jparams, model, params = pair(ARCH, n_blocks=13)
    assert model.cfg.n_tail == 1
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    feed = rng.integers(0, 256, (GEN, B, 1)).astype(np.int32)
    out, _, _ = teacher_forced(jmodel, jparams, model, params, toks, feed,
                               MAX_LEN, bf16=True, jit=False)
    for got, want in out:
        np.testing.assert_allclose(got, want, rtol=RTOL_BF16,
                                   atol=ATOL_BF16)


def test_lora_goes_through_the_raw_shared_wo():
    """``_ffn_with_lora`` adds (h a) b wo to the shared FFN, as the
    reference does: float32, within 1e-5."""
    jmodel, jparams, model, params = pair(ARCH, f32=True)
    h = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(
        np.float32)
    jlora = jax.tree.map(lambda a: a[1], jparams["segments"]["lora"])
    lora = {k: v[1] for k, v in params["segments"]["lora"].items()}
    want = jmodel._ffn_with_lora(jparams["shared"], jlora, jnp.asarray(h))
    got = model._ffn_with_lora(params["shared"], lora, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    base = model._ffn_with_lora(params["shared"],
                                {k: torch.zeros_like(v)
                                 for k, v in lora.items()},
                                torch.from_numpy(h))
    assert float((got - base).abs().max()) > 1e-3


def test_packed_through_the_reference_placement(tmp_path):
    """``--pud-attention``: the shared block's wq / wk / wv / wo (one pack
    each, serving all uses) and the unembed; its FFN sits under
    ``shared/ffn``, no packable scope, and stays bf16.  Names and placed
    columns equal the reference's; decode within the packed tolerance of
    the op-by-op reference (13 blocks, as above)."""
    jmodel, jparams, model, params = pair(ARCH, n_blocks=13)
    jpacked, packed, s = placed_pair(ARCH, jparams, params, tmp_path,
                                     attention=True)
    assert packed.packed_names == (
        "shared/attn/wk", "shared/attn/wo", "shared/attn/wq",
        "shared/attn/wv", "unembed/w")
    assert s.placement.capacity_report()["used_cols"] == 4 * 64 + 256
    assert "wi" in packed.params["shared"]["ffn"]
    toks = np.random.default_rng(8).integers(0, 256, (B, S)).astype(
        np.int32)
    check_packed_decode(jmodel, jpacked, model, packed, toks, GEN, MAX_LEN,
                        jit=False)


def test_engine_refuses_the_hybrid():
    """The Mamba2 segment caches carry the batch on axis 2, which the
    engine's slot lanes (axis 1) cannot serve; the reference's engine
    fails on the same model (``test_torch_families_serve.py``)."""
    model = get(ARCH).make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")
    why = engine_refusal(model)
    assert "seg_mamba/conv" in why and "batch on axis 1" in why
    with pytest.raises(ValueError, match="batch on axis 1"):
        ServingEngine(model, params, max_len=16, batch_size=2)
