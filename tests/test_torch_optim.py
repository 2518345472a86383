"""The port's AdamW (``repro_torch/runtime/optim.py``) against the
reference's: the schedule, the global norm, int8 compression and the update
fed identical gradients (float32 and bf16 parameters, with and without
compression), and the reference's descent cases on the port."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.runtime import optim as ref  # noqa: E402
from repro_torch.runtime import optim  # noqa: E402

CFG = dict(peak_lr=1e-2, warmup_steps=3, total_steps=20, min_lr_ratio=0.1)


def _tree(rng):
    """A small parameter tree (numpy); ``nested/b`` turns bf16 in the bf16
    cases."""
    return {"w": rng.standard_normal((6, 40)).astype(np.float32),
            "nested": {"b": rng.standard_normal((300,)).astype(np.float32),
                       "s": rng.standard_normal((3,)).astype(np.float32)}}


def _j(tree, bf16):
    return jax.tree.map(jnp.asarray, tree) if not bf16 else {
        "w": jnp.asarray(tree["w"]),
        "nested": {"b": jnp.asarray(tree["nested"]["b"], jnp.bfloat16),
                   "s": jnp.asarray(tree["nested"]["s"])}}


def _t(tree, bf16):
    # copies: the port updates in place, and jnp.asarray may share memory
    out = optim.tree_map(lambda a: torch.from_numpy(a.copy()), tree)
    if bf16:
        out["nested"]["b"] = out["nested"]["b"].to(torch.bfloat16)
    return out


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(tree, np.float32)


def _assert_tree_close(got, want, rtol, atol=0.0):
    got, want = _np(got), _np(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], rtol, atol)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 10, 19, 20, 50])
def test_lr_schedule_matches_reference(step):
    cfg, jcfg = optim.OptConfig(**CFG), ref.OptConfig(**CFG)
    got = optim.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = ref.lr_schedule(jcfg, jnp.int32(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=2e-7)


def test_lr_schedule_shape():
    """The reference's own schedule case, on the port."""
    cfg = optim.OptConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(optim.lr_schedule(cfg, torch.tensor(s)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)


def test_init_opt_state_and_global_norm_match_reference():
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    for compress in (False, True):
        st = optim.init_opt_state(_t(tree, False),
                                  optim.OptConfig(compress_grads=compress))
        jst = ref.init_opt_state(_j(tree, False),
                                 ref.OptConfig(compress_grads=compress))
        assert sorted(st) == sorted(jst)
        assert st["step"].dtype == torch.int32 and st["step"].ndim == 0
        for k in ("mu", "nu") + (("residual",) if compress else ()):
            assert st[k]["w"].dtype == torch.float32
            assert st[k]["w"].shape == jst[k]["w"].shape
    got = optim.global_norm(_t(tree, True))
    want = ref.global_norm(_j(tree, True))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("n", [97, 256, 1000])
def test_compress_roundtrip_matches_reference(n):
    g = (np.random.default_rng(n).standard_normal(n) * 10).astype(np.float32)
    g_hat, err = optim.compress_roundtrip(torch.from_numpy(g))
    j_hat, j_err = ref.compress_roundtrip(jnp.asarray(g))
    np.testing.assert_array_equal(g_hat.numpy(), np.asarray(j_hat))
    np.testing.assert_array_equal(err.numpy(), np.asarray(j_err))


@pytest.mark.parametrize("seed", range(5))
def test_compress_roundtrip_error_bound(seed):
    """The reference's bound: g_hat + err == g, and each element's error is
    at most half its block's scale."""
    g = torch.randn(97, generator=torch.Generator().manual_seed(seed)) * 10
    g_hat, err = optim.compress_roundtrip(g)
    np.testing.assert_allclose((g_hat + err).numpy(), g.numpy(), rtol=1e-5,
                               atol=1e-5)
    scale = float(g.abs().max()) / 127
    assert float(err.abs().max()) <= scale * 0.5 + 1e-6


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_reference_on_identical_grads(compress, bf16):
    """Three updates fed the same gradients: parameters, moments,
    residuals, the grad norm and the lr agree with the reference's."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    cfg = optim.OptConfig(**CFG, compress_grads=compress)
    jcfg = ref.OptConfig(**CFG, compress_grads=compress)
    params, jparams = _t(tree, bf16), _j(tree, bf16)
    state = optim.init_opt_state(params, cfg)
    jstate = ref.init_opt_state(jparams, jcfg)
    jupd = jax.jit(lambda p, g, s: ref.adamw_update(p, g, s, jcfg))
    for i in range(3):
        g = _tree(np.random.default_rng(10 + i))
        params, state, m = optim.adamw_update(params, _t(g, bf16), state, cfg)
        jparams, jstate, jm = jupd(jparams, _j(g, bf16), jstate)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=2e-7)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        _assert_tree_close(state["mu"], jstate["mu"], rtol=1e-5, atol=1e-7)
        _assert_tree_close(state["nu"], jstate["nu"], rtol=1e-5, atol=1e-9)
        if compress:
            _assert_tree_close(state["residual"], jstate["residual"],
                               rtol=1e-4, atol=1e-6)
        # float32 leaves within float32 rounding; a bf16 leaf within one
        # bf16 ulp (the update rounds once into bf16)
        _assert_tree_close(params, jparams, rtol=8e-3 if bf16 else 1e-6,
                           atol=1e-7)
    assert params["nested"]["b"].dtype == (torch.bfloat16 if bf16
                                           else torch.float32)


def test_adamw_descends_quadratic():
    cfg = optim.OptConfig(peak_lr=0.1, warmup_steps=1, total_steps=100,
                          weight_decay=0.0)
    params = {"x": torch.tensor([3.0, -2.0])}
    state = optim.init_opt_state(params, cfg)
    for _ in range(60):
        grads = {"x": 2 * params["x"]}
        params, state, _ = optim.adamw_update(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 0.5


def test_compressed_training_still_descends():
    cfg = optim.OptConfig(peak_lr=0.1, warmup_steps=1, total_steps=100,
                          weight_decay=0.0, compress_grads=True)
    params = {"x": torch.linspace(-3, 3, 32)}
    state = optim.init_opt_state(params, cfg)
    assert "residual" in state
    for _ in range(60):
        grads = {"x": 2 * params["x"]}
        params, state, _ = optim.adamw_update(params, grads, state, cfg)
    assert float(params["x"].abs().max()) < 0.5


def test_adamw_update_is_in_place():
    """The parameters and moments are updated in place (the reference's
    launcher donates them), so a step holds one copy of the state."""
    cfg = optim.OptConfig(**CFG)
    params = {"x": torch.ones(4)}
    state = optim.init_opt_state(params, cfg)
    x, mu = params["x"], state["mu"]["x"]
    new, new_state, _ = optim.adamw_update(params, {"x": torch.ones(4)},
                                           state, cfg)
    assert new["x"] is x and new_state["mu"]["x"] is mu
    assert float(x[0]) < 1.0 and float(mu[0]) > 0.0
