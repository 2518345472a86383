"""Shared set-up of the training parity tests
(``tests/test_torch_train_{dense,moe,ssm,multimodal}.py``): each smoke
arch's ``train_loss`` and gradients in both packages, on the reference's
weights (``_families.pair``) and one numpy-drawn batch.

Tolerances, each gradient leaf against its largest magnitude in the
reference:
  * float32 (params and ``cfg.dtype`` float32 on both sides, the reference
    jitted): loss within 1e-4, every leaf within ``F32_TOL``;
  * bf16 (the reference run op by op under ``jax.disable_jit``: PyTorch
    rounds every bf16 op, as XLA does only outside its fused kernels):
    loss within ``BF16_LOSS_TOL``, every leaf within ``BF16_GRAD_TOL``; the
    hybrid within ``HYBRID_GRAD_TOL`` (it amplifies an ulp, ROADMAP Queue
    3).  Measured worst leaves: 0.022 (deepseek-67b), 0.043 (the hybrid).
``chip_smoke.py``'s train group holds each arch's step on the card to the
same step on the CPU: in float32 within 10 x ``F32_TOL`` (the two devices
sum GEMMs and scatter-adds in other orders; gemma's embedding gradient
differed by 2.8e-4), in bf16 within ``BF16_LOSS_TOL`` / the hybrid's
``HYBRID_GRAD_TOL`` or, where larger, the CPU's own bf16-vs-float32
difference on the leaf (bf16 rounding's noise floor: the hybrid's smoke
model moves its bf16 gradients by up to 3.5x a leaf's scale against
float32 on the CPU alone).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _families import as_j, as_t, frontend, leaves, pair, vocab
from repro_torch.runtime.steps import microbatch_grads

#: batch rows and text length: 40 is not a multiple of the smoke configs'
#: loss_chunk (32), so the loss pads its last chunk
B, S = 2, 40
F32_TOL = 1e-4
BF16_LOSS_TOL = 1e-3
BF16_GRAD_TOL = 0.05
HYBRID_GRAD_TOL = 0.1


def batches(arch, model, seed=1, bf16=False):
    """(the reference's batch, the port's) from one numpy draw: tokens,
    labels, a random 0/1 mask and the stub frontend's input."""
    rng = np.random.default_rng(seed)
    ex, _ = frontend(arch, model, B, rng)
    v = vocab(model)
    toks = rng.integers(0, v, (B, S)).astype(np.int32)
    labels = rng.integers(0, v, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "mask": jnp.asarray(mask), **as_j(ex, bf16)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "mask": torch.from_numpy(mask), **as_t(ex, bf16)}
    return jb, tb


def check_train_loss(arch: str, f32: bool) -> dict:
    """Loss, metrics and every gradient leaf of both packages; asserts the
    tolerances above and returns the worst leaf's error."""
    # op by op, JAX cannot scan the hybrid smoke config's empty tail: 13
    # blocks give it one
    fields = dict(n_blocks=13) if arch == "zamba2-7b" and not f32 else {}
    jm, jp, m, p = pair(arch, f32=f32, **fields)
    jb, tb = batches(arch, m, bf16=not f32)
    fn = jax.value_and_grad(lambda pp: jm.train_loss(pp, jb), has_aux=True)
    if f32:
        (jl, jmet), jg = jax.jit(fn)(jp)
    else:
        with jax.disable_jit():
            (jl, jmet), jg = fn(jp)
    tl, tg = microbatch_grads(m, p, tb)
    with torch.no_grad():
        _, met = m.train_loss(p, tb)
    loss_tol = 1e-4 if f32 else BF16_LOSS_TOL
    assert abs(float(tl) - float(jl)) <= loss_tol, (float(tl), float(jl))
    assert sorted(met) == sorted(jmet)
    for k in met:
        assert abs(float(met[k]) - float(jmet[k])) <= loss_tol, k
    tol = F32_TOL if f32 else (HYBRID_GRAD_TOL if arch == "zamba2-7b"
                               else BF16_GRAD_TOL)
    ref = dict(leaves(jax.tree.map(lambda x: np.asarray(x, np.float32), jg)))
    got = dict(leaves(tg))
    assert got.keys() == ref.keys()
    worst = 0.0
    for path, g in got.items():
        r = ref[path]
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, path
        if r.size == 0:
            continue
        scale = float(np.abs(r).max())
        err = float(np.abs(g.numpy() - r).max())
        assert np.isfinite(err) and err <= tol * max(scale, 1e-6), \
            (path, err, scale)
        worst = max(worst, err / max(scale, 1e-6))
    return {"worst": worst}
