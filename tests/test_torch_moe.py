"""Parity of the port's mixture-of-experts layer (``models/moe.py``) with
the JAX package's ``repro/models/moe.py``: routing, capacity-bounded
dispatch, the combine, the shared experts and the Switch auxiliary loss,
on the same inputs (drawn with numpy from a seed) and the reference's
weights (carried across with ``from_numpy``).

Tolerances: float32 outputs within 1e-4 and the auxiliary loss within
1e-6; bf16 outputs equal bit for bit (both packages run the layer op by op
here; the port's SiLU follows ``jax.nn.silu``'s operation order and its
combine, summed in float32 in ascending expert order, rounds as the
reference's scatter-add does on these inputs).

The tie cases: ``jax.lax.top_k`` breaks ties toward the lower index and
``torch.topk`` does not.  A llama4-smoke decode step at batch 4 (top-1, so
every routed token's normalised score is exactly 1.0; a capacity of 2
tokens per expert) keeps the reference's tokens only with the stable sort:
the same step with ``torch.topk`` in its place differs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import from_numpy, init_params  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _layer(dtype_name, seed=0, **kw):
    """A MoE layer's config and weights in both packages."""
    jdt, tdt = DTYPES[dtype_name]
    base = dict(d_model=32, n_experts=8, top_k=2, d_ff_expert=24,
                n_shared_experts=1, d_ff_shared=24)
    base.update(kw)
    jcfg, cfg = j_moe.MoEConfig(**base), moe.MoEConfig(**base)
    jp = jax.tree.map(np.asarray, j_init(j_moe.moe_defs(jcfg, jdt),
                                         jax.random.key(seed)))
    return jcfg, cfg, jax.tree.map(jnp.asarray, jp), from_numpy(jp, "cpu")


def _run(jcfg, cfg, jp, p, x, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    jy, jaux = j_moe.moe_ffn(jp, jcfg, jnp.asarray(x, jdt))
    with torch.inference_mode():
        y, aux = moe.moe_ffn(p, cfg, torch.from_numpy(x).to(tdt))
    return np.asarray(jy, np.float32), float(jaux), y.float().numpy(), \
        float(aux)


def _check(jy, jaux, y, aux, dtype_name):
    assert np.isclose(aux, jaux, rtol=0, atol=1e-6), (aux, jaux)
    if dtype_name == "float32":
        np.testing.assert_allclose(y, jy, rtol=0, atol=1e-4)
    else:
        np.testing.assert_array_equal(y, jy)


def test_moe_defs_match_reference_router_float32():
    jcfg, cfg, _, p = _layer("bfloat16")
    jd, d = j_moe.moe_defs(jcfg), moe.moe_defs(cfg)
    assert sorted(d) == sorted(jd)
    for k in ("router", "wi", "wg", "wo"):
        assert (d[k].shape, d[k].axes, d[k].init) == \
            (jd[k].shape, jd[k].axes, jd[k].init)
    assert d["router"].dtype == torch.float32
    assert p["router"].dtype == torch.float32       # through from_numpy
    assert p["wi"].dtype == torch.bfloat16
    q = init_params(d, 0, "cpu")                    # and the port's init
    assert q["router"].dtype == torch.float32 and q["wi"].dim() == 3


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_groups_match_reference(dtype_name, seed):
    """Three groups of 10 tokens: one group per batch row."""
    jcfg, cfg, jp, p = _layer(dtype_name, seed)
    x = np.random.default_rng(seed).standard_normal((3, 10, 32)).astype(
        np.float32)
    _check(*_run(jcfg, cfg, jp, p, x, dtype_name), dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_decode_regroups_batch(dtype_name):
    """S == 1: the batch of 5 regroups into one group (capacity 2 of 5)."""
    jcfg, cfg, jp, p = _layer(dtype_name, 2)
    assert moe._capacity(cfg, 5) == j_moe._capacity(jcfg, 5) == 2
    x = np.random.default_rng(3).standard_normal((5, 1, 32)).astype(
        np.float32)
    _check(*_run(jcfg, cfg, jp, p, x, dtype_name), dtype_name)


def _routed_and_kept(cfg, p, x):
    """(tokens routed to an expert, tokens it kept) over one group x."""
    probs = torch.softmax(x @ p["router"], dim=-1)
    _, topi = moe._top_k(probs, cfg.top_k)
    counts = torch.bincount(topi.reshape(-1), minlength=cfg.n_experts)
    cap = moe._capacity(cfg, x.shape[0])
    return counts, torch.clamp(counts, max=cap)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_capacity_drops_tokens_like_reference(dtype_name):
    """A skewed router over 4 experts: more tokens choose an expert than
    its capacity of 11, so some are dropped, as in the reference."""
    jcfg, cfg, jp, p = _layer(dtype_name, 4, n_experts=4)
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, 16, 32)) + 3 * rng.standard_normal(32)
         ).astype(np.float32)
    routed, kept = _routed_and_kept(cfg, p, torch.from_numpy(x[0]))
    assert moe._capacity(cfg, 16) == 11 and int((routed - kept).sum()) > 0
    _check(*_run(jcfg, cfg, jp, p, x, dtype_name), dtype_name)


def test_stable_top_k_breaks_ties_like_jax():
    v = np.array([0, 1, 0, 1, 1, 0, 0, 1], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(v), 3)
    _, got = moe._top_k(torch.from_numpy(v), 3)
    assert got.tolist() == np.asarray(want).tolist() == [1, 3, 4]


def _llama4_decode_inputs():
    """The llama4 smoke model's first MoE layer (reference weights) and a
    decode batch of 4 whose tokens all route to one expert: top-1 scores
    all tie at 1.0 and that expert keeps 2 of them."""
    arch = "llama4-scout-17b-a16e"
    jmodel = j_get(arch).make_smoke()
    model = get(arch).make_smoke()
    jp = jax.tree.map(np.asarray, j_init(jmodel.param_defs(),
                                         jax.random.key(0)))
    jlayer = jax.tree.map(lambda a: a[0], jp["layers_0_moe"]["mixer"])
    rng = np.random.default_rng(0)
    base = rng.standard_normal(64)
    x = (base + 0.01 * rng.standard_normal((4, 1, 64))).astype(np.float32)
    return (jmodel.cfg.moe_config(), model.cfg.moe_config(),
            jax.tree.map(jnp.asarray, jlayer), from_numpy(jlayer, "cpu"), x)


def test_llama4_decode_all_ties_keep_reference_tokens():
    jcfg, cfg, jp, p, x = _llama4_decode_inputs()
    assert cfg.top_k == 1 and moe._capacity(cfg, 4) == 2
    routed, kept = _routed_and_kept(cfg, p, torch.from_numpy(x[:, 0]))
    assert int(routed.max()) >= 3 and int((routed - kept).sum()) > 0
    jy, jaux, y, aux = _run(jcfg, cfg, jp, p, x, "bfloat16")
    _check(jy, jaux, y, aux, "bfloat16")


def test_llama4_decode_with_torch_topk_differs(monkeypatch):
    """The same step with ``torch.topk`` in place of the stable sort keeps
    other tokens and so differs from the reference."""
    jcfg, cfg, jp, p, x = _llama4_decode_inputs()
    jy, _, y, _ = _run(jcfg, cfg, jp, p, x, "bfloat16")
    np.testing.assert_array_equal(y, jy)
    monkeypatch.setattr(moe, "_top_k",
                        lambda v, k: torch.topk(v, k, dim=-1))
    _, _, y_unstable, _ = _run(jcfg, cfg, jp, p, x, "bfloat16")
    assert not np.array_equal(y_unstable, jy)


def test_combine_accumulates_in_expert_order():
    """Each token's output sums its experts' contributions in ascending
    expert order in float32, rounded once: equal to a loop over experts."""
    _, cfg, _, p = _layer("float32", 6, n_shared_experts=0)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (12, 32)).astype(np.float32))
    with torch.inference_mode():
        y, _, _ = moe._group(p, cfg, x)
        probs = torch.softmax(x @ p["router"], dim=-1)
        topv, topi = moe._top_k(probs, cfg.top_k)
        topv = topv / topv.sum(-1, keepdim=True)
        want = torch.zeros_like(x)
        for e in range(cfg.n_experts):      # capacity 4 of 12: some drop
            score = torch.where(topi == e, topv, 0).sum(-1)
            gate, idx = moe._top_k(score, moe._capacity(cfg, 12))
            for g, t in zip(gate.tolist(), idx.tolist()):
                if g > 0:
                    h = torch.nn.functional.silu(x[t] @ p["wg"][e]) * \
                        (x[t] @ p["wi"][e])
                    want[t] += (h @ p["wo"][e]) * g
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_init_params_draws_expert_banks_by_slice(monkeypatch):
    """A leaf above ``_DRAW_ELEMS`` elements (deepseek-v2-lite's expert
    banks) draws one leading slice at a time from its own generator: the
    same values on every call, scaled by its fan-in, without a float32
    copy of the whole leaf; smaller leaves draw at once, as before."""
    import math
    from repro_torch.core.rng import generator
    from repro_torch.models import params as params_mod
    from repro_torch.models.params import ParamDef
    defs = {"banks": ParamDef((3, 64, 48), ("experts", "embed", "mlp"),
                              dtype=torch.bfloat16, init="scaled"),
            "router": ParamDef((64, 3), ("embed", None), init="scaled")}
    whole = init_params(defs, 5, "cpu")
    monkeypatch.setattr(params_mod, "_DRAW_ELEMS", 64 * 48)
    sliced = init_params(defs, 5, "cpu")
    assert torch.equal(sliced["router"], whole["router"])
    assert torch.equal(sliced["banks"], init_params(defs, 5, "cpu")["banks"])
    assert sliced["banks"].dtype == torch.bfloat16
    g = generator(5, "params", "banks", device=torch.device("cpu"))
    first = (torch.randn((64, 48), generator=g) / math.sqrt(64)).to(
        torch.bfloat16)
    assert torch.equal(sliced["banks"][0], first)
    assert not torch.equal(sliced["banks"][0], sliced["banks"][1])
