"""Shared set-up of the parity tests of the SSM, hybrid, encoder-decoder
and VLM families (``tests/test_torch_{ssm,hybrid,encdec,vlm,
families_serve}.py``): smoke models of both packages on the reference's
weights, carried across with ``from_numpy``."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get as j_get
from repro.models.params import init_params as j_init
from repro_torch.configs import get
from repro_torch.models.params import from_numpy

#: leaves redrawn N(0, 0.5) so that they matter: the RMSNorm scales, the
#: SSM's decay, step bias and skip (0, 0 and 1 at init), the LoRA's
#: up-projection (zeros at init)
REDRAWN = ("scale", "a_log", "dt_bias", "d_skip", "ffn_b")


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def redraw(tree, rng, path=()):
    """A numpy tree with every ``REDRAWN`` leaf drawn N(0, 0.5)."""
    if isinstance(tree, dict):
        return {k: redraw(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree)
    if path[-1] in REDRAWN:
        return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
    return a


def with_cfg(model, **fields):
    """``model`` rebuilt with config fields replaced; ``dtype`` reaches a
    VLM's text backbone."""
    cfg = model.cfg
    if hasattr(cfg, "lm"):
        lm_fields = {k: fields.pop(k) for k in list(fields)
                     if hasattr(cfg.lm, k)}
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm,
                                                              **lm_fields))
    return type(model)(dataclasses.replace(cfg, **fields))


def pair(arch, seed=0, f32=False, **fields):
    """(reference model, its params, port model, port params) of the smoke
    config (``fields`` replaced in both; ``f32``: float32 configs), on the
    reference's weights with the ``REDRAWN`` leaves redrawn."""
    jmodel, model = j_get(arch).make_smoke(), get(arch).make_smoke()
    if f32:
        jmodel = with_cfg(jmodel, dtype=jnp.float32, **fields)
        model = with_cfg(model, dtype=torch.float32, **fields)
    elif fields:
        jmodel, model = with_cfg(jmodel, **fields), with_cfg(model, **fields)
    jp = jax.tree.map(np.asarray,
                      j_init(jmodel.param_defs(), jax.random.key(seed)))
    jp = redraw(jp, np.random.default_rng(seed))
    return jmodel, jax.tree.map(jnp.asarray, jp), model, \
        from_numpy(jp, "cpu")


def frontend(arch, model, batch, rng, dtype=np.float32):
    """The stub frontend's input of ``arch`` drawn from ``rng`` (0.1 x
    N(0, 1)) as numpy: ({} | {"patches"} | {"frames"}, prefix length)."""
    fam, c = get(arch).family, model.cfg
    if fam == "vlm":
        return {"patches": (0.1 * rng.standard_normal(
            (batch, c.n_patches, c.d_vit))).astype(dtype)}, c.n_patches
    if fam == "encdec":
        return {"frames": (0.1 * rng.standard_normal(
            (batch, c.n_frames, c.d_model))).astype(dtype)}, 0
    return {}, 0


def as_j(extras, bf16=False):
    """numpy extras -> the reference's arrays (bf16 for a bf16 model)."""
    return {k: jnp.asarray(v, jnp.bfloat16 if bf16 else jnp.float32)
            for k, v in extras.items()}


def as_t(extras, bf16=False):
    """numpy extras -> the port's tensors (bf16 for a bf16 model)."""
    return {k: torch.from_numpy(v).to(torch.bfloat16 if bf16
                                      else torch.float32)
            for k, v in extras.items()}


def vocab(model) -> int:
    return getattr(model.cfg, "lm", model.cfg).vocab


def teacher_forced(jmodel, jparams, model, params, toks, feed, max_len,
                   extras=None, prefix=0, bf16=False, ref_cache=False,
                   jit=True):
    """Prefill, then one decode step per ``feed`` row, in both packages;
    returns [(port logits, reference logits)] as numpy float32 pairs.
    ``ref_cache``: each port step starts from the reference's cache of
    the step before (so errors do not compound); ``jit``: the reference
    jitted, else op by op."""
    extras = extras or {}
    s = toks.shape[1]
    jf = (jax.jit(jmodel.prefill, static_argnames=("max_len",)) if jit
          else jmodel.prefill)
    step = jax.jit(jmodel.decode_step) if jit else jmodel.decode_step
    ctx = contextlib.nullcontext() if jit else jax.disable_jit()
    out = []
    with ctx:
        jl, jc = jf(jparams, jnp.asarray(toks),
                    *as_j(extras, bf16).values(), max_len=max_len)
        with torch.inference_mode():
            lg, cache = model.prefill(params, torch.from_numpy(toks),
                                      *as_t(extras, bf16).values(),
                                      max_len=max_len)
        out.append((lg.float().numpy(), np.asarray(jl, np.float32)))
        for i, f in enumerate(feed):
            if ref_cache:
                cache = from_numpy(jax.tree.map(np.asarray, jc), "cpu")
            jl, jc = step(jparams, jc, jnp.asarray(f),
                          jnp.int32(s + prefix + i))
            with torch.inference_mode():
                lg, cache = model.decode_step(params, cache,
                                              torch.from_numpy(f),
                                              s + prefix + i)
            out.append((lg.float().numpy(), np.asarray(jl, np.float32)))
    return out, cache, jc


GRID = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=512)


def placed_pair(arch, jparams, params, tmp_path, attention=False):
    """The reference calibrates, places and packs (4-bit, the FFN and
    unembed packs, the attention's with ``attention``); the port's session
    opens the same directory and must hit its table and placement.
    Returns (reference PackedModel, port PackedModel, port session)."""
    from repro.core.calibrate import CalibrationConfig as JCal
    from repro.core.fleet import FleetConfig as JFleet
    from repro.pud.gemv import ATTN_PACKABLE as J_ATTN
    from repro.pud.gemv import FFN_PACKABLE as J_FFN
    from repro.pud.gemv import PUDGemvConfig as JGemvCfg
    from repro.runtime.session import PUDSession as JSession
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,
                                      PUDGemvConfig)
    from repro_torch.runtime.session import PUDSession
    name = f"{arch}-smoke"
    js = JSession.open(arch, grid=JFleet(**GRID), cache_dir=tmp_path,
                       calib=JCal(n_iterations=4, n_samples=64),
                       key=jax.random.key(2), n_trials_ecr=128,
                       backend="reference")
    js.calibrate()
    jpacked = js.pack(jparams, JGemvCfg(
        packable=J_FFN + (J_ATTN if attention else ())), name=name)
    s = PUDSession.open(arch, grid=FleetConfig(**GRID), cache_dir=tmp_path,
                        calib=CalibrationConfig(n_iterations=4,
                                                n_samples=64),
                        seed=2, n_trials_ecr=128, device="cpu")
    assert s.calibrate().cache_hit
    packed = s.pack(params, PUDGemvConfig(
        packable=FFN_PACKABLE + (ATTN_PACKABLE if attention else ())),
        name=name)
    assert s.placement_status == "hit" and packed.placed
    assert tuple(packed.packed_names) == tuple(jpacked.packed_names)
    assert s.placement.capacity_report()["used_cols"] == \
        js.placement.capacity_report()["used_cols"]
    return jpacked, packed, s


def check_packed_decode(jmodel, jpacked, model, packed, toks, gen, max_len,
                        extras=None, prefix=0, jit=True, atol=0.1):
    """Packed logits teacher-forced on the reference's greedy tokens within
    ``atol``; the port's own greedy tokens equal the reference's up to the
    first step whose reference top-2 margin is at most twice the measured
    logits difference (a near-tie may break either way)."""
    from repro.launch.serve import greedy_generate as j_generate
    from repro_torch.launch.serve import greedy_generate
    extras = extras or {}
    ctx = contextlib.nullcontext() if jit else jax.disable_jit()
    with ctx:
        jt, jl = j_generate(jmodel, jpacked.params, jnp.asarray(toks), gen,
                            max_len, as_j(extras, True), prefix)
    jt, jl = np.asarray(jt), np.asarray(jl, np.float32)
    b, s = toks.shape
    ex = tuple(as_t(extras, True).values())
    with torch.inference_mode():
        lg, cache = model.prefill(packed.params, torch.from_numpy(toks), *ex,
                                  max_len=max_len)
        forced = [lg]
        for i in range(gen - 1):
            lg, cache = model.decode_step(packed.params, cache,
                                          torch.tensor(jt[:, i:i + 1]),
                                          s + prefix + i)
            forced.append(lg)
    forced = torch.stack(forced, dim=1).numpy()
    np.testing.assert_allclose(forced, jl[:, :gen], rtol=0, atol=atol)
    delta = float(np.abs(forced - jl[:, :gen]).max())
    top2 = np.sort(jl[:, :gen], axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * delta
    t, _ = greedy_generate(model, packed.params, torch.from_numpy(toks), gen,
                           max_len, as_t(extras, True), prefix)
    for row in range(b):
        upto = gen if clear[row].all() else int(np.argmin(clear[row]))
        np.testing.assert_array_equal(t.numpy()[row, :upto], jt[row, :upto])
    return delta
