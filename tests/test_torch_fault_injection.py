"""Fault injection in the port: the proof that placement matters (port of
``tests/test_placement.py``'s fault-injection tests), held against the JAX
package.

The smoke qwen3-1.7b (2 layers, d 64, vocab 256) packs its FFN and
attention projections at 4 bits (the port packs attention too), placed on
masks of an 8 x 512 grid (p = 0.25, seed 3) with ``avoid_faulty=True``
and in the identity layout.  Weights cross over with ``from_numpy``.

- Corrupted planes and refreshed fault masks equal the reference's bit
  for bit.
- In the port, decoding the fault-injected placed packs gives logits
  bit-identical to the clean packs; the identity layout computes on
  faulty columns and its logits move by more than 0.1.
- The port's corrupted identity logits are within 0.1 of the reference's:
  the packed-path tolerance of ``test_torch_serve.py`` (bf16 activations
  differ by an ulp between the packages, which can move one int8
  activation step).

Decoding is teacher-forced (prefill of 8 tokens, then two decode steps on
fixed tokens), so both packages see the same inputs at every step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.pud import placement as jpl  # noqa: E402
from repro.pud.gemv import ATTN_PACKABLE as J_ATTN  # noqa: E402
from repro.pud.gemv import FFN_PACKABLE as J_FFN  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.packer import pack_for_serving as j_pack  # noqa: E402
from repro.pud.packer import packing_requests as j_requests  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.pud import placement as pl  # noqa: E402
from repro_torch.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,  # noqa: E402
                                  PUDGemvConfig)
from repro_torch.pud.packer import pack_for_serving, packing_requests  # noqa: E402

ARCH = "qwen3-1.7b"
PUD_ATTN = PUDGemvConfig(weight_bits=4, packable=FFN_PACKABLE + ATTN_PACKABLE)
J_PUD_ATTN = JGemvCfg(weight_bits=4, packable=J_FFN + J_ATTN,
                      backend="reference")
ATOL_PACKED = 0.1


def _masks(g=8, c=512, p=0.25, seed=3):
    return np.random.default_rng(seed).random((g, c)) < p


@pytest.fixture(scope="module")
def setup():
    jmodel = j_get(ARCH).make_smoke()
    jparams = j_init(jmodel.param_defs(), jax.random.key(0))
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    reqs = packing_requests(params, PUD_ATTN)
    jreqs = j_requests(jparams, J_PUD_ATTN)
    assert [(r.name, r.n_cols, r.n_slices) for r in reqs] == \
        [(r.name, r.n_cols, r.n_slices) for r in jreqs]
    masks = _masks()
    plans = {avoid: pl.plan_placement(masks, reqs, avoid_faulty=avoid)
             for avoid in (True, False)}
    jplans = {avoid: jpl.plan_placement(masks, jreqs, avoid_faulty=avoid)
              for avoid in (True, False)}
    packs = {avoid: pack_for_serving(params, PUD_ATTN,
                                     placement=plans[avoid])[0]
             for avoid in (True, False)}
    jpacks = {avoid: j_pack(jparams, J_PUD_ATTN,
                            placement=jplans[avoid])[0]
              for avoid in (True, False)}
    return dict(jmodel=jmodel, model=get(ARCH).make_smoke(), plans=plans,
                jplans=jplans, packs=packs, jpacks=jpacks)


def _tokens():
    rng = np.random.default_rng(2)
    return (rng.integers(0, 256, (2, 8)).astype(np.int32),
            rng.integers(0, 256, (2, 2)).astype(np.int32))


def _decode_logits(model, p):
    prompt, nxt = map(torch.from_numpy, _tokens())
    with torch.inference_mode():
        logits, cache = model.prefill(p, prompt, max_len=12)
        out = [logits]
        for i in range(nxt.shape[1]):
            logits, cache = model.decode_step(p, cache, nxt[:, i:i + 1],
                                              8 + i)
            out.append(logits)
    return torch.stack(out, dim=1)


def _j_decode_logits(jmodel, p):
    prompt, nxt = map(jnp.asarray, _tokens())
    logits, cache = jmodel.prefill(p, prompt, max_len=12)
    out = [logits]
    for i in range(nxt.shape[1]):
        logits, cache = jmodel.decode_step(p, cache, nxt[:, i:i + 1],
                                           jnp.int32(8 + i))
        out.append(logits)
    return np.asarray(jnp.stack(out, axis=1), np.float32)


def _placed_packs(tree, path=()):
    for key, sub in tree.items():
        if key.endswith("_pud") and sub.placed:
            yield "/".join(path + (key[:-4],)), sub
        elif isinstance(sub, dict):
            yield from _placed_packs(sub, path + (key,))


@pytest.mark.parametrize("avoid", [True, False], ids=["placed", "identity"])
def test_corrupted_planes_equal_reference(setup, avoid):
    hurt = pl.inject_read_faults(setup["packs"][avoid], setup["plans"][avoid])
    jhurt = jpl.inject_read_faults(setup["jpacks"][avoid],
                                   setup["jplans"][avoid])
    names = []
    for name, pt in _placed_packs(hurt):
        jt = jhurt
        for part in name.split("/")[:-1]:
            jt = jt[part]
        jt = jt[name.split("/")[-1] + "_pud"]
        assert pt.planes.dtype == torch.uint8
        np.testing.assert_array_equal(pt.planes.numpy(),
                                      np.asarray(jt.planes))
        np.testing.assert_array_equal(pt.col_ids.numpy(),
                                      np.asarray(jt.col_ids))
        names.append(name)
    # wq wk wv wo, wi wg wo and the unembed
    assert len(names) == 8 and names[-1] == "unembed/w"
    # the clean packs are left as they were
    clean = dict(_placed_packs(setup["packs"][avoid]))
    corrupted = sum(int((clean[n].planes != pt.planes).sum())
                    for n, pt in _placed_packs(hurt))
    assert corrupted > 0


@pytest.mark.parametrize("avoid", [True, False])
def test_corrupt_planes_dense_and_stuck_values(setup, avoid):
    """Dense planes take the stuck bit, words 0xFF / 0x00, exactly as the
    reference's; faulty columns of the window only."""
    name, pt = next(_placed_packs(setup["packs"][avoid]))
    tp = setup["plans"][avoid].entries[name]
    from repro_torch.pud.packed import to_dense
    dense = to_dense(pt).planes
    got = pl.corrupt_planes(dense, tp)
    want = jpl.corrupt_planes(jnp.asarray(dense.numpy()),
                              setup["jplans"][avoid].entries[name])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    words = pl.corrupt_planes(pt.planes, tp)
    f = torch.from_numpy(np.asarray(tp.faulty, bool))
    s = torch.from_numpy(np.asarray(tp.stuck, np.int8)).bool()
    cols = words.permute(0, 3, 1, 2)          # [L, W, WB, Kw]
    assert bool((cols[f & s] == 0xFF).all()) and bool((cols[f & ~s] == 0)
                                                     .all())
    assert torch.equal(cols[~f], pt.planes.permute(0, 3, 1, 2)[~f])


@pytest.mark.parametrize("with_offsets", [False, True])
def test_refresh_fault_state_equals_reference(setup, with_offsets):
    new_masks = _masks(seed=4)
    offs = (np.random.default_rng(5).standard_normal(new_masks.shape) * 0.03
            if with_offsets else None)
    for avoid in (True, False):
        got = pl.refresh_fault_state(setup["plans"][avoid], new_masks, offs)
        want = jpl.refresh_fault_state(setup["jplans"][avoid], new_masks,
                                       offs)
        for name, tp in got.entries.items():
            jt = want.entries[name]
            for f in ("faulty", "stuck", "phys_cols", "block_starts"):
                np.testing.assert_array_equal(np.asarray(getattr(tp, f)),
                                              np.asarray(getattr(jt, f)))
        old = setup["plans"][avoid]
        assert got.used_per_subarray is old.used_per_subarray
        assert any((got.entries[n].faulty != old.entries[n].faulty).any()
                   for n in got.entries)


def test_fault_injection_placed_exact_unplaced_corrupted(setup):
    """Decode logits are bit-identical under injected faulty-column reads
    with placement enabled, and measurably corrupted without it; the
    corrupted identity logits agree with the reference's."""
    model, packs, plans = setup["model"], setup["packs"], setup["plans"]
    clean = _decode_logits(model, packs[True])
    # sanity: the identity layout is numerically identical while fault-free
    assert torch.equal(_decode_logits(model, packs[False]), clean)
    hurt_placed = _decode_logits(
        model, pl.inject_read_faults(packs[True], plans[True]))
    hurt_ident = _decode_logits(
        model, pl.inject_read_faults(packs[False], plans[False]))
    assert torch.equal(hurt_placed, clean)
    delta = float((hurt_ident - clean).abs().max())
    assert delta > 0.1, delta
    jhurt = _j_decode_logits(setup["jmodel"], jpl.inject_read_faults(
        setup["jpacks"][False], setup["jplans"][False]))
    np.testing.assert_allclose(hurt_ident.numpy(), jhurt, rtol=0,
                               atol=ATOL_PACKED)


def test_inject_requires_matching_placement(setup):
    empty = dataclasses.replace(setup["plans"][True], entries={})
    with pytest.raises(KeyError, match="no placement entry"):
        pl.inject_read_faults(setup["packs"][True], empty)
    # unplaced packs pass through untouched
    unplaced, _ = pack_for_serving(
        from_numpy(jax.tree.map(np.asarray, j_init(
            setup["jmodel"].param_defs(), jax.random.key(0))), "cpu"),
        PUD_ATTN)
    assert pl.inject_read_faults(unplaced, empty)["unembed"]["w_pud"] is \
        unplaced["unembed"]["w_pud"]
