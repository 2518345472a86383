"""The port's sharding context against ``repro/models/sharding_ctx.py``
(the reference's ``tests/test_sharding_hints.py`` cases), and activation
head padding: ``gqa_attention`` and ``gqa_prefill_chunk`` under rules with
a 4-way "model" axis (6 heads, 3 kv heads: padded to 8) equal the
reference's unpadded functions within 2e-5 (float32), the cache keeping
the true kv-head count.  The reference's own padded run needs a mesh its
jax refuses (ROADMAP Queue 3), so its unpadded result is the yardstick, as
its test holds its padded run to it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.models import attention as jattn  # noqa: E402
from repro.models import sharding_ctx as jctx  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import sharding_ctx  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402

TOL = 2e-5
RULES = {"batch": "data", "heads": None, "heads_act": "model",
         "_mesh_sizes": {"data": 1, "model": 4}}


@pytest.fixture(autouse=True)
def no_rules():
    sharding_ctx.set_rules(None)
    yield
    sharding_ctx.set_rules(None)
    jctx.set_rules(None)


def test_hint_returns_its_input():
    x = torch.ones(2, 3)
    assert sharding_ctx.hint(x, "batch", None) is x
    sharding_ctx.set_rules(RULES)     # eager: nothing to constrain
    assert sharding_ctx.hint(x, "batch", "heads_act") is x
    assert sharding_ctx.get_rules() is RULES


@pytest.mark.parametrize("rules", [
    None,
    {"heads": "model", "heads_act": "model",
     "_mesh_sizes": {"data": 16, "model": 16}},
    {"heads": "model", "_mesh_sizes": {"model": 8}},
    {"heads": "model", "heads_act": None, "_mesh_sizes": {"model": 16}},
    {"heads": "model"}])
@pytest.mark.parametrize("n", [40, 20, 16, 64, 6, 1])
def test_padded_head_count_matches_reference(rules, n):
    sharding_ctx.set_rules(rules)
    jctx.set_rules(rules)
    assert sharding_ctx.padded_head_count(n) == jctx.padded_head_count(n)


def test_padded_head_count_cases():
    assert sharding_ctx.padded_head_count(40) == 40
    sharding_ctx.set_rules({"heads": "model", "heads_act": "model",
                            "_mesh_sizes": {"data": 16, "model": 16}})
    assert [sharding_ctx.padded_head_count(n) for n in (40, 20, 16, 64)] \
        == [48, 32, 16, 64]


def _setup():
    cfg = jattn.AttnConfig(d_model=32, n_heads=6, n_kv_heads=3, head_dim=8,
                           kv_chunk=16)
    tcfg = attn.AttnConfig(d_model=32, n_heads=6, n_kv_heads=3, head_dim=8,
                           kv_chunk=16)
    from repro.models.params import init_params as j_init
    jp = jax.tree.map(np.asarray, j_init(jattn.gqa_defs(cfg, jnp.float32),
                                         jax.random.key(0)))
    x = np.random.default_rng(1).standard_normal((4, 32, 32)).astype(
        np.float32)
    return cfg, tcfg, jp, from_numpy(jp, "cpu"), x


def _spy_heads(monkeypatch):
    seen = []
    flash = attn._flash

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2]))
        return flash(q, k, v, **kw)
    monkeypatch.setattr(attn, "_flash", spy)
    return seen


def test_gqa_attention_padded_equals_reference(monkeypatch):
    cfg, tcfg, jp, p, x = _setup()
    positions = np.broadcast_to(np.arange(32), (4, 32))
    ref, (rk, rv) = jattn.gqa_attention(jax.tree.map(jnp.asarray, jp), cfg,
                                        jnp.asarray(x),
                                        jnp.asarray(positions))
    seen = _spy_heads(monkeypatch)
    sharding_ctx.set_rules(RULES)
    with torch.no_grad():
        got, (k, v) = attn.gqa_attention(p, tcfg, torch.from_numpy(x),
                                         torch.from_numpy(positions.copy()))
    assert seen == [(8, 8)]            # 6 heads -> 8, kv expanded and padded
    assert k.shape[2] == cfg.n_kv_heads == rk.shape[2]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), rtol=TOL, atol=TOL)
    sharding_ctx.set_rules(None)       # unpadded: the same values
    with torch.no_grad():
        plain, _ = attn.gqa_attention(p, tcfg, torch.from_numpy(x),
                                      torch.from_numpy(positions.copy()))
    assert seen[-1] == (6, 3)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=TOL,
                               atol=TOL)


def test_gqa_prefill_chunk_padded_equals_reference(monkeypatch):
    cfg, tcfg, jp, p, x = _setup()
    smax, start, c, kv_len = 32, 8, 8, 16
    rng = np.random.default_rng(2)
    ck = rng.standard_normal((4, smax, 3, 8)).astype(np.float32)
    cv = rng.standard_normal((4, smax, 3, 8)).astype(np.float32)
    xs = x[:, :c]
    ref, rk, rv = jattn.gqa_prefill_chunk(
        jax.tree.map(jnp.asarray, jp), cfg, jnp.asarray(xs), jnp.asarray(ck),
        jnp.asarray(cv), start, kv_len)
    seen = _spy_heads(monkeypatch)
    sharding_ctx.set_rules(RULES)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    with torch.no_grad():
        got = attn.gqa_prefill_chunk(p, tcfg, torch.from_numpy(xs.copy()),
                                     tk, tv, start, kv_len)
    assert seen == [(8, 8)]
    assert tk.shape == ck.shape        # the cache keeps 3 kv heads
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(rk), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=TOL,
                               atol=TOL)
