"""The training step's pieces: ``chunked_softmax_xent`` (S not a chunk
multiple) against the reference's, remat on == off bit for bit in the
port, and ``make_train_step`` at 1 and 2 microbatches against the
reference's ``make_train_step(batch_axes=None)`` over 3 steps fed the
reference's own batches (float32: loss, grad norm and lr within 1e-4)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _families import pair  # noqa: E402
from _train import batches  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.runtime import data as jdata  # noqa: E402
from repro.runtime import optim as joptim  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.runtime import optim  # noqa: E402
from repro_torch.runtime.steps import (make_eval_loss,  # noqa: E402
                                       make_train_step, microbatch_grads)


@pytest.mark.parametrize("s,chunk", [(40, 16), (48, 16), (7, 32)])
def test_chunked_xent_matches_reference(s, chunk):
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = (0.3 * rng.standard_normal((24, 50))).astype(np.float32)
    y = rng.integers(0, 50, (2, s)).astype(np.int32)
    m = (rng.random((2, s)) < 0.7).astype(np.float32)
    ht, wt = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w)
    wt.requires_grad_()
    loss, cnt = layers.chunked_softmax_xent({"w": wt}, ht,
                                            torch.from_numpy(y),
                                            torch.from_numpy(m), chunk=chunk)
    gh, gw = torch.autograd.grad(loss, [ht, wt])

    def jloss(hh, ww):
        return jlayers.chunked_softmax_xent({"w": ww}, hh, jnp.asarray(y),
                                            jnp.asarray(m), chunk=chunk)

    jl, jc = jloss(h, w)
    jgh, jgw = jax.grad(lambda a, b: jloss(a, b)[0], argnums=(0, 1))(h, w)
    assert float(cnt) == float(jc) == float(m.sum())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), atol=1e-6)
    # no mask: every position counts
    _, n = layers.chunked_softmax_xent({"w": wt}, ht, torch.from_numpy(y),
                                       chunk=chunk)
    assert float(n) == 2 * s


def _with_remat(model, on: bool):
    cfg = model.cfg
    if hasattr(cfg, "lm"):
        return type(model)(dataclasses.replace(
            cfg, lm=dataclasses.replace(cfg.lm, remat=on)))
    return type(model)(dataclasses.replace(cfg, remat=on))


@pytest.mark.parametrize("arch", all_archs())
def test_remat_on_equals_off_bit_for_bit(arch):
    model = get(arch).make_smoke()
    params = init_params(model.param_defs(), 3, "cpu")
    _, tb = batches(arch, model, bf16=True)
    out = []
    for on in (True, False):
        m = _with_remat(model, on)
        assert getattr(m.cfg, "lm", m.cfg).remat is on
        out.append(microbatch_grads(m, params, tb, 2))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(g1),
                                                 optim.tree_leaves(g2)))
    assert torch.equal(make_eval_loss(model)(params, tb),
                       model.train_loss(params, tb)[0].detach())


def _ref_batches(model, n, b, s):
    """The reference's own data stream, as numpy."""
    cfg = jdata.DataConfig(vocab=getattr(model.cfg, "lm", model.cfg).vocab,
                           seq_len=s, global_batch=b, seed=5)
    pipe = jdata.DataPipeline(cfg)
    return [{k: np.asarray(v) for k, v in pipe.batch_at(i).items()}
            for i in range(n)]


@pytest.mark.parametrize("arch,k", [("qwen3-1.7b", 1), ("qwen3-1.7b", 2),
                                    ("deepseek-v2-lite-16b", 2)])
def test_make_train_step_trajectory_matches_reference(arch, k):
    jm, jp, m, p = pair(arch, f32=True)
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jcfg, cfg = joptim.OptConfig(**kw), optim.OptConfig(**kw)
    jstep = jax.jit(jsteps.make_train_step(jm, jcfg, microbatches=k,
                                           batch_axes=None))
    step = make_train_step(m, cfg, microbatches=k)
    jstate, state = joptim.init_opt_state(jp, jcfg), optim.init_opt_state(
        p, cfg)
    for i, b in enumerate(_ref_batches(m, 3, 4, 24)):
        jp, jstate, jmet = jstep(jp, jstate, jax.tree.map(jnp.asarray, b),
                                 jnp.uint32(i))
        p, state, met = step(p, state, {n: torch.tensor(v)
                                        for n, v in b.items()})
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                       rtol=1e-4, err_msg=f"{name} @ {i}")
    assert int(state["step"]) == int(jstate["step"]) == 3


def test_microbatches_split_rows_in_order():
    """[B, ...] -> [k, B / k, ...] row-major: microbatch i is rows
    [i B/k, (i+1) B/k); a batch that does not split raises."""
    from repro_torch.runtime.steps import _split_microbatches
    x = torch.arange(12).reshape(6, 2)
    sp = _split_microbatches({"x": x, "s": torch.tensor(3)}, 3)
    assert torch.equal(sp["x"][1], x[2:4]) and sp["s"].ndim == 0
    with pytest.raises(ValueError, match="microbatches"):
        _split_microbatches({"x": x}, 4)
