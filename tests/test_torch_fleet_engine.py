"""The port's ``FleetServingEngine`` against the JAX package's single-device
``ServingEngine`` over the unsharded pack of the same weights: what the
reference's own ``tests/test_fleet_engine.py`` asserts of its fleet (which
cannot run on this tree's jax), held of the port.

The model is the float32 qwen3-1.7b smoke config, widened (d_ff and vocab
512) so that both model shards of a projection own columns; the weights
are the reference's (``from_numpy``).  A (data 2, model 2) fleet serves
the requests, placed and logical.

Tolerances: tokens equal the reference's; logits within atol 0.1, the
packed-path tolerance of ``test_torch_chunked_prefill.py`` (XLA and
PyTorch round float32 activations apart by an ulp, which can move an int8
activation step).  Within the port, every lane's tokens and logits equal
a single-device engine's over the port's unsharded logical pack, bit for
bit, with the lane's requests in the lane's order on as many slots.
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
from repro.models.transformer import TransformerLM as JLM  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.packer import pack_model as j_pack_model  # noqa: E402
from repro.runtime.engine import Request as JRequest  # noqa: E402
from repro.runtime.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.pud.gemv import PUDGemvConfig  # noqa: E402
from repro_torch.pud.packer import pack_model  # noqa: E402
from repro_torch.runtime.engine import (FleetServingEngine,  # noqa: E402
                                        Request, ServingEngine)
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

ARCH = "qwen3-1.7b"
MAX_LEN, GEN, PROMPT, SLOTS = 16, 4, 8, 2
ATOL_PACKED = 0.1
GRID = dict(n_channels=1, n_banks=1, n_subarrays=4, n_cols=512)


@pytest.fixture(scope="module")
def setup():
    jm = j_get(ARCH).make_smoke()
    jm = JLM(dataclasses.replace(jm.cfg, d_ff=512, vocab=512,
                                 dtype=jnp.float32))
    model = get(ARCH).make_smoke()
    model = TransformerLM(dataclasses.replace(model.cfg, d_ff=512, vocab=512,
                                              dtype=torch.float32))
    jp = jax.tree.map(np.asarray, j_init(jm.param_defs(), jax.random.key(0)))
    params = from_numpy(jp, "cpu")
    prompts = np.random.default_rng(1).integers(0, 512, (4, PROMPT)).astype(
        np.int32)
    jref = JEngine(jm, j_pack_model(jax.tree.map(jnp.asarray, jp),
                                    JGemvCfg(backend="reference")).params,
                   max_len=MAX_LEN, batch_size=SLOTS, collect_logits=True)
    ref = {c.request_id: c for c in jref.run(
        [JRequest(request_id=i, tokens=jnp.asarray(p), max_new_tokens=GEN)
         for i, p in enumerate(prompts)])}
    mesh = make_host_mesh(2, 2, device="cpu")
    fleets = {}
    for placed in (True, False):
        f = PUDSession.open_fleet(
            ARCH, mesh=mesh, grid=FleetConfig(**GRID),
            calib=CalibrationConfig(n_iterations=4, n_samples=64), seed=7,
            n_trials_ecr=128, placement=placed)
        f.calibrate()
        f.pack(params, PUDGemvConfig(weight_bits=4), name=f"eng-{placed}")
        fleets[placed] = f
    return dict(model=model, params=params, prompts=prompts, ref=ref,
                fleets=fleets)


def _requests(prompts, ids=None):
    ids = range(len(prompts)) if ids is None else ids
    return [Request(request_id=i, tokens=torch.from_numpy(prompts[i]),
                    max_new_tokens=GEN) for i in ids]


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "logical"])
def test_fleet_decode_equals_single_device(setup, placed):
    model, f = setup["model"], setup["fleets"][placed]
    assert all(pm.placed == placed for pm in f.packs)
    eng = f.serving_engine(model, max_len=MAX_LEN, batch_size=SLOTS,
                           collect_logits=True)
    assert eng.n_lanes == 2 and eng.batch_size == SLOTS
    comps = eng.run(_requests(setup["prompts"]))
    assert [c.request_id for c in comps] == [0, 1, 2, 3]
    for c in comps:                    # against the reference's engine
        r = setup["ref"][c.request_id]
        assert c.tokens == list(np.asarray(r.tokens)), c.request_id
        np.testing.assert_allclose(c.logits.numpy(), np.asarray(r.logits),
                                   rtol=0, atol=ATOL_PACKED)
    # within the port, bit for bit: each lane == one engine over the
    # unsharded logical pack with the lane's requests and slots
    logical = pack_model(setup["params"], PUDGemvConfig(weight_bits=4))
    for d, lane in enumerate(eng.lanes):
        ids = [c.request_id for c in lane._completions]
        assert ids == [i for i in range(4) if i % 2 == d]   # round-robin
        single = ServingEngine(model, logical.params, max_len=MAX_LEN,
                               batch_size=SLOTS, collect_logits=True)
        for c, w in zip(sorted(lane._completions,
                               key=lambda c: c.request_id),
                        single.run(_requests(setup["prompts"], ids))):
            assert c.tokens == w.tokens
            assert torch.equal(c.logits, w.logits)
    rep = eng.scheduler_report()
    assert rep["n_lanes"] == 2 and rep["completed"] == 4
    assert rep["generated_tokens"] == 4 * GEN and len(rep["lanes"]) == 2
    perf = eng.perf_report(2 * get(ARCH).n_active_params)
    assert perf["n_devices"] == 4
    assert perf["n_data"] == 2 and perf["n_model"] == 2
    assert perf["aggregate_tok_s"] > 0
    assert 0 < perf["scaling_efficiency"] <= 1.0


def test_submit_routes_by_prefix_affinity(setup):
    """With per-lane prefix caches a repeated prompt goes to the lane that
    holds its prefill, even off the round-robin turn; a shared cache
    across lanes is refused."""
    model, f = setup["model"], setup["fleets"][True]
    eng = f.serving_engine(model, max_len=MAX_LEN, batch_size=SLOTS,
                           prefix_cache=True)
    p = setup["prompts"]
    assert eng.submit(_requests(p, [0])[0]) == 0
    eng.run()
    assert eng.submit(_requests(p, [1])[0]) == 1       # round-robin
    assert eng.submit(_requests(p, [0])[0]) == 0       # lane 0 holds it
    eng.run()
    assert eng.scheduler_report()["prefix_cache"]["hits"] >= 1
    with pytest.raises(ValueError, match="shared PrefixCache"):
        FleetServingEngine(model, [pm.params for pm in f.packs],
                           max_len=MAX_LEN, prefix_cache=PrefixCache())


def test_lane_hot_swap_and_default_batch(setup):
    """``stage_lane_params`` swaps one lane at its next step; the default
    slot count is each lane's shard-0 session optimum."""
    model, f = setup["model"], setup["fleets"][True]
    eng = f.serving_engine(model, max_len=MAX_LEN)
    assert [lane.batch_size for lane in eng.lanes] == [
        row[0].optimal_batch_size(32) for row in f.sessions]
    eng.stage_lane_params(1, f.packs[1].params)
    assert eng.lanes[1].swap_pending and not eng.lanes[0].swap_pending
    eng.step()
    assert not eng.lanes[1].swap_pending
    assert eng.lanes[1].scheduler_report()["swaps"] == 1
