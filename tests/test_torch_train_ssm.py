"""``train_loss`` and its gradients in both packages for the SSM and the
hybrid (mamba2-1.3b, zamba2-7b): the SSD's chunked scan and the shared
block, at smoke size (``tests/_train.py``: float32 within 1e-4, bf16
against the reference run op by op within the stated tolerances)."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _train import check_train_loss  # noqa: E402

ARCHS = ['mamba2-1.3b', 'zamba2-7b']


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_f32(arch):
    check_train_loss(arch, f32=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_op_by_op_bf16(arch):
    check_train_loss(arch, f32=False)


def test_ssd_backward_is_nan_where_the_decay_overflows_in_both_packages():
    """A reference fault the port keeps (ROADMAP Queue 3): the SSD's
    intra-chunk decay is ``where(tri, exp(cs_t - cs_s), 0)``.  Above the
    diagonal cs_t - cs_s is the positive sum of dt x |A| over the steps
    between, and once it passes ~88 its exp is inf in float32; the forward
    discards it, but the backward multiplies the zero gradient the where
    sends there by that inf.  With dt ~8 (step bias 8, A = -1) a 16-step
    chunk reaches ~120: the loss stays finite, the same gradient elements
    are NaN in both packages, and the finite ones agree."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from _families import leaves, pair
    from repro_torch.runtime.steps import microbatch_grads

    jm, jp, m, p = pair("mamba2-1.3b", f32=True)
    for tree, full in ((jp["layers"]["mamba"], jnp.full_like),
                       (p["layers"]["mamba"], torch.full_like)):
        tree["dt_bias"] = full(tree["dt_bias"], 8.0)
        tree["a_log"] = full(tree["a_log"], 0.0)
    toks = np.random.default_rng(0).integers(0, 256, (1, 32)).astype(
        np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda pp: jm.train_loss(
        pp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})[0]))(
        jp)
    tl, tg = microbatch_grads(m, p, {"tokens": torch.from_numpy(toks),
                                     "labels": torch.from_numpy(toks)})
    assert np.isfinite(float(jl)) and abs(float(tl) - float(jl)) < 1e-4
    ref = dict(leaves(jax.tree.map(np.asarray, jg)))
    n_nan = 0
    for path, g in leaves(tg):
        g, r = g.numpy(), ref[path]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), path)
        n_nan += int(np.isnan(g).sum())
        ok = ~np.isnan(r)
        if ok.any():
            scale = max(float(np.abs(r[ok]).max()), 1e-6)
            assert float(np.abs(g[ok] - r[ok]).max()) <= 1e-4 * scale, path
    assert n_nan > 0
