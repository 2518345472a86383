"""Parity of the port's drift subsystem (``repro_torch.runtime.drift``, the
session's canaries, ``core/reliability.DriftSimulator``) with the JAX
package's, and the port's whole recovery loop on the reference test's smoke
configuration (``tests/test_drift.py``: qwen3-1.7b smoke, an 8 x 1,024
grid, drift at step 3).

Exact: the EMA detector is numpy float32 logic, so fed the same canary-ECR
sequences it gives the reference's events and EMA bit for bit; with the
reference's calibration table carried across (both packages read one cache
format), a canary-reserving session's placement and its persisted name
equal the reference's; the recovered engine's tokens equal a fresh decode
on the recovered pack.  The loop's probes draw from the port's own
streams, so it is held to the reference's acceptance checks, not to its
numbers.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.core.reliability import DriftSimulator as JSim  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.runtime import drift as jdrift  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.canary import probe_ecr  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.core.reliability import DriftSimulator  # noqa: E402
from repro_torch.core.rng import generator  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models.params import from_numpy, init_params  # noqa: E402
from repro_torch.pud.gemv import PUDGemvConfig  # noqa: E402
from repro_torch.pud.placement import (inject_read_faults,  # noqa: E402
                                       refresh_fault_state)
from repro_torch.runtime import drift  # noqa: E402
from repro_torch.runtime.engine import Request  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

ARCH = "qwen3-1.7b"
GRID = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=1024)
CAL = dict(n_iterations=4, n_samples=64)
MAX_LEN, GEN, PROMPT = 16, 4, 8
DRIFT_TEMP_C = 3000.0      # the reference test's stress temperature


# ---------------------------------------------------------------------------
# Detector
# ---------------------------------------------------------------------------

def _sequences(seed, g, rounds):
    """Canary ECRs quantized to 1/16 (16 canaries): churn of 0-2 flips,
    occasional spikes of 3-14 flips."""
    rng = np.random.default_rng(seed)
    flips = rng.integers(0, 3, (rounds, g))
    spikes = rng.random((rounds, g)) < 0.15
    flips[spikes] = rng.integers(3, 15, spikes.sum())
    return (flips / 16).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detector_events_and_ema_equal_reference(seed):
    cfg = drift.DriftConfig()
    jcfg = jdrift.DriftConfig()
    assert dataclass_fields(cfg) == dataclass_fields(jcfg)
    det, jdet = drift.DriftDetector(6, cfg), jdrift.DriftDetector(6, jcfg)
    rng = np.random.default_rng(100 + seed)
    for r, ecr in enumerate(_sequences(seed, 6, 40)):
        if rng.random() < 0.2:
            subs = rng.choice(6, 2, replace=False).tolist()
            det.rebaseline(subs)
            jdet.rebaseline(subs)
        evs, jevs = det.update(ecr, r), jdet.update(ecr, r)
        # the reference's events also carry ``shard`` (0 on one device):
        # the fleet monitor's field, which the port leaves to the fleet
        # session
        assert [dict(dataclass_fields(e), shard=0) for e in evs] == \
            [dataclass_fields(e) for e in jevs]
        assert det.ema.dtype == jdet.ema.dtype == np.float32
        np.testing.assert_array_equal(det.ema, jdet.ema)
    assert len(det.events) == len(jdet.events) > 0
    assert {e.severity for e in det.events} == {"warn", "critical"}


def test_detector_thresholds_ema_and_rebaseline():
    """The reference test's own sequence, on both detectors."""
    emas = []
    for mod in (drift, jdrift):
        det = mod.DriftDetector(3, mod.DriftConfig())
        assert det.update([0.05, 0.0, 0.0], 0) == []
        assert det.ema[0] == pytest.approx(0.0125)
        evs = det.update([0.2, 0.5, 0.1], 1)
        assert [(e.subarray, e.severity) for e in evs] == [(0, "warn"),
                                                           (1, "critical")]
        det.rebaseline([1])
        assert det.update([0.0, 0.45, 0.0], 2) == []
        assert det.ema[1] == pytest.approx(0.45)
        assert det.update([0.0, 0.9, 0.0], 3)[0].severity == "critical"
        emas.append(det.ema)
    np.testing.assert_array_equal(*emas)


def dataclass_fields(obj) -> dict:
    import dataclasses
    return dataclasses.asdict(obj)


# ---------------------------------------------------------------------------
# Canary-aware placement against the reference's, on its calibration table
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_and_port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("canary-plan")
    jmodel = j_get(ARCH).make_smoke()
    jparams = j_init(jmodel.param_defs(), jax.random.key(0))
    ref = JSession.open(ARCH, grid=JFleet(**GRID), calib=JCal(**CAL), key=7,
                        n_trials_ecr=128, cache_dir=tmp / "ref",
                        backend="reference")
    ref.calibrate()
    # the port reads a copy made before the reference plans, so its plan
    # cannot be the reference's persisted one
    shutil.copytree(tmp / "ref", tmp / "port")
    ref.reserve_canaries(16)
    ref.pack(jparams, JGemvCfg(weight_bits=4), name="drift")
    port = PUDSession.open(ARCH, grid=FleetConfig(**GRID),
                           calib=CalibrationConfig(**CAL), seed=7,
                           n_trials_ecr=128, cache_dir=tmp / "port",
                           device="cpu")
    assert port.calibrate().cache_hit
    port.reserve_canaries(16)
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    port.pack(params, PUDGemvConfig(weight_bits=4), name="drift")
    return ref, port


def test_canary_placement_equals_reference(ref_and_port):
    ref, port = ref_and_port
    np.testing.assert_array_equal(port.canaries.cols, ref.canaries.cols)
    assert port.canaries.fingerprint() == ref.canaries.fingerprint()
    assert port.placement_status == ref.placement_status == "planned"
    assert port.placement_name == ref.placement_name
    assert port.placement_name.endswith(f"-c{ref.canaries.fingerprint()}")
    assert list(port.placement.entries) == list(ref.placement.entries)
    for name, tp in ref.placement.entries.items():
        np.testing.assert_array_equal(port.placement.entries[name].phys_cols,
                                      np.asarray(tp.phys_cols))
    # no tensor sits on a canary
    n = GRID["n_cols"]
    flat = {g * n + int(c) for g, row in enumerate(port.canaries.cols)
            for c in row}
    placed = {int(c) for tp in port.placement.entries.values()
              for c in np.asarray(tp.phys_cols).ravel()}
    assert placed and not placed & flat


def test_monitor_report_and_overhead_equal_reference(ref_and_port):
    ref, port = ref_and_port
    mon = drift.DriftMonitor(port, DriftSimulator.for_session(port))
    jmon = jdrift.DriftMonitor(ref, JSim.for_session(ref))
    assert mon.probe_overhead() == pytest.approx(jmon.probe_overhead(),
                                                 rel=1e-12)
    assert 0.0 < mon.probe_overhead() < 0.05
    rep, jrep = mon.report(), jmon.report()
    assert list(rep) == list(jrep)
    assert rep["table_age"]["assumed_temp_c"] == \
        jrep["table_age"]["assumed_temp_c"]


def test_canary_less_plan_is_never_reused(tmp_path):
    model = get(ARCH).make_smoke()
    params = init_params(model.param_defs(), 0, "cpu")

    def session():
        s = PUDSession.open(ARCH, grid=FleetConfig(**GRID),
                            calib=CalibrationConfig(**CAL), seed=7,
                            n_trials_ecr=128, cache_dir=tmp_path,
                            device="cpu")
        s.calibrate()
        return s

    plain = session()
    plain.pack(params, PUDGemvConfig(weight_bits=4), name="x")
    assert plain.placement_status == "planned"
    with_c = session()
    with_c.reserve_canaries(16)
    with_c.pack(params, PUDGemvConfig(weight_bits=4), name="x")
    assert with_c.placement_status == "planned"
    assert with_c.placement_name == (
        plain.placement_name + f"-c{with_c.canaries.fingerprint()}")
    again = session()
    again.reserve_canaries(16)
    again.pack(params, PUDGemvConfig(weight_bits=4), name="x")
    assert again.placement_status == "hit"


def test_monitor_needs_a_calibrated_session_and_reserves():
    s = PUDSession.open(ARCH, grid=FleetConfig(**GRID),
                        calib=CalibrationConfig(**CAL), seed=7,
                        n_trials_ecr=128, device="cpu")
    with pytest.raises(RuntimeError, match="calibrated"):
        drift.DriftMonitor(s, None)
    with pytest.raises(RuntimeError, match="calibrate"):
        s.reserve_canaries(4)
    s.calibrate()
    mon = drift.DriftMonitor(s, DriftSimulator.for_session(s),
                             config=drift.DriftConfig(n_canary=8))
    assert s.canaries.n_per_subarray == 8
    # an undrifted device reads at most the churn floor: nothing critical
    assert not [e for e in mon.probe() if e.severity == "critical"]
    assert mon.probe_rounds == 1 and len(mon.last_canary_ecr) == 8


# ---------------------------------------------------------------------------
# The whole recovery loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    model = get(ARCH).make_smoke()
    return model, init_params(model.param_defs(), 0, "cpu")


def _session(seed=7):
    s = PUDSession.open(ARCH, grid=FleetConfig(**GRID),
                        calib=CalibrationConfig(**CAL), seed=seed,
                        n_trials_ecr=128, device="cpu")
    s.calibrate()
    return s


def _prompts(model, n):
    return [torch.randint(0, model.cfg.vocab, (PROMPT,),
                          generator=generator(1, "prompt", i),
                          dtype=torch.int32) for i in range(n)]


def _requests(prompts, base_id=0):
    return [Request(request_id=base_id + i, tokens=p, max_new_tokens=GEN)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("hot", ["1,5", "placed,5"])
def test_full_recovery_loop(smoke, hot):
    model, params = smoke
    s = _session()
    s.reserve_canaries(16)
    s.pack(params, PUDGemvConfig(weight_bits=4), name="drift")
    levels0 = s.calibration.levels.clone()
    clean = s.packed.params

    eng = s.serving_engine(model, max_len=MAX_LEN, batch_size=2)
    sim = DriftSimulator.for_session(s)
    mon = drift.DriftMonitor(s, sim, config=drift.DriftConfig(probe_every=2))

    def read_faults(packed_params):
        pl = refresh_fault_state(s.placement,
                                 s.calibration.masks.numpy(),
                                 sim.sense_offsets().numpy())
        return inject_read_faults(packed_params, pl)

    ctl = drift.DriftController(eng, mon, params, pack_name="drift",
                                read_faults=read_faults)
    prompts = _prompts(model, 8)
    eng.submit_all(_requests(prompts[:6]))
    for _ in range(3):
        ctl.step()

    used = np.asarray(s.placement.used_per_subarray)
    subs = sorted({int(np.argmax(used)) if h == "placed" else int(h)
                   for h in hot.split(",")})
    sim.advance(temp_c=DRIFT_TEMP_C, subarrays=subs)
    _, gt_masks = probe_ecr(0xF0, sim.sense_offsets(), mon._charges(),
                            s.physics, s.n_fracs, n_trials=128)
    eng.params = inject_read_faults(
        eng.params, refresh_fault_state(s.placement, gt_masks.numpy(),
                                        sim.sense_offsets().numpy()))
    if hot.startswith("placed"):       # the corruption reaches the pack
        assert any(not torch.equal(a.planes, b.planes)
                   for a, b in zip(_packs(eng.params), _packs(clean)))

    guard = 0
    while (eng.n_pending or eng.n_active or ctl.phase != "monitor"
           or eng.swap_pending):
        ctl.step()
        guard += 1
        assert guard < 200, "recovery loop did not converge"

    rep = ctl.report()
    assert len(rep["recoveries"]) == 1
    rec = rep["recoveries"][0]
    assert rec["subarrays"] == subs
    keep = [g for g in range(GRID["n_subarrays"]) if g not in subs]
    assert torch.equal(s.calibration.levels[keep], levels0[keep])
    assert all(e > 0.3 for e in rec["canary_ecr_at_detection"].values())
    assert rec["recalibrate_wall_s"] > 0 and rec["repack_wall_s"] > 0
    assert rep["swap_steps"] and all(t > 0 for t in rep["swap_step_tokens"])
    assert rep["min_tokens_per_step"] > 0
    # the repacked placement avoids every refreshed fault and every canary
    bad = (s.calibration.masks.numpy() | s.canaries.mask()).reshape(-1)
    placed = np.concatenate([np.asarray(tp.phys_cols).ravel()
                             for tp in s.placement.entries.values()])
    assert not bad[placed].any()

    post = _requests(prompts[6:], base_id=100)
    comps = {c.request_id: c for c in ctl.run(post)}
    fresh = s.packed.params
    for r in post:
        want, _ = greedy_generate(model, fresh, r.tokens[None, :], GEN,
                                  MAX_LEN)
        assert comps[r.request_id].tokens == want[0].tolist()


def _packs(tree):
    from repro_torch.pud.packed import PackedTensor
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _packs(v)
    elif isinstance(tree, PackedTensor):
        yield tree


def test_recovered_tokens_match_an_independent_fresh_session(smoke):
    """After recovery the session decodes as one calibrated from scratch
    with another seed: placement restored the exact integer contract."""
    model, params = smoke
    s = _session()
    s.reserve_canaries(16)
    s.pack(params, PUDGemvConfig(weight_bits=4), name="recovered")
    sim = DriftSimulator.for_session(s)
    sim.advance(temp_c=DRIFT_TEMP_C, subarrays=[1])
    s.recalibrate_subarrays([1], sim.sense_offsets())
    s.pack(params, PUDGemvConfig(weight_bits=4), name="recovered")
    other = _session(seed=11)
    other.pack(params, PUDGemvConfig(weight_bits=4), name="fresh")
    toks = torch.stack(_prompts(model, 2))
    got, _ = greedy_generate(model, s.packed.params, toks, GEN, MAX_LEN)
    want, _ = greedy_generate(model, other.packed.params, toks, GEN, MAX_LEN)
    assert torch.equal(got, want)
