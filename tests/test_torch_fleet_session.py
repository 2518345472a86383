"""The port's fleet session against the JAX package's.

The reference opens a (data 2, model 2) fleet without a mesh, calibrates
every device into a temp cache, plans per-shard placements and packs; the
port's ``open_fleet`` on the same cache reads every table and placement
(a HIT: the cache keys on the device id, the grid and the physics, and
device (d, m) is ``<id>-d{d}m{m}`` in both), and its packs equal the
reference's fleet packs bit for bit.  Planned again from the same masks,
the placements equal the reference's too.  Then the fleet's own
semantics, as the reference's ``tests/test_fleet_session.py`` holds them:
a lane falls back to the logical layout as a whole, ``recalibrate_shard``
moves only the owning shard, and ``FleetDriftMonitor`` routes events to
the shard that raised them.

Tolerances: none (tables, placements, packs and the rate models'
float64 arithmetic are held exactly; the rate models to rel 1e-12).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.models.transformer import TransformerLM as JLM  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.packer import pack_model_sharded as j_pack_sharded  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.core.reliability import DriftSimulator  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.pud.gemv import PUDGemvConfig  # noqa: E402
from repro_torch.runtime.drift import (DriftConfig,  # noqa: E402
                                       FleetDriftMonitor)
from repro_torch.runtime.session import PUDSession  # noqa: E402
from test_torch_fleet_packs import _assert_same_sharded  # noqa: E402
from test_torch_placement import _assert_same  # noqa: E402

ARCH = "qwen3-1.7b"
GRID = dict(n_channels=1, n_banks=1, n_subarrays=4, n_cols=512)
NAME = "fleet-parity"
DRIFT_TEMP_C = 3000.0     # far past the envelope: certain detection


def _port_fleet(cache_dir=None, **kw):
    return PUDSession.open_fleet(
        ARCH, n_data=2, n_model=2, grid=FleetConfig(**GRID),
        cache_dir=cache_dir, calib=CalibrationConfig(n_iterations=4,
                                                     n_samples=64),
        seed=7, n_trials_ecr=128, device="cpu", **kw)


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """The reference's calibrated, packed fleet and the port's on its
    cache, on the qwen3 smoke model widened so both shards own columns
    (d_ff and vocab 512: two window blocks each)."""
    cache = tmp_path_factory.mktemp("fleet")
    jmodel = j_get(ARCH).make_smoke()
    jmodel = JLM(dataclasses.replace(jmodel.cfg, d_ff=512, vocab=512))
    jparams = j_init(jmodel.param_defs(), jax.random.key(0))
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jf = JSession.open_fleet(ARCH, n_data=2, n_model=2, grid=JFleet(**GRID),
                             cache_dir=cache, calib=JCal(n_iterations=4,
                                                         n_samples=64),
                             key=7, n_trials_ecr=128, backend="reference")
    jf.calibrate()
    jpacks = jf.pack(jparams, JGemvCfg(weight_bits=4), name=NAME)
    f = _port_fleet(cache)
    states = f.calibrate()
    packs = f.pack(params, PUDGemvConfig(weight_bits=4), name=NAME)
    return dict(jf=jf, jpacks=jpacks, jparams=jparams, f=f, states=states,
                packs=packs, params=params)


@pytest.fixture(scope="module")
def own():
    """A port fleet calibrated by the port (no cache): its tables match the
    offsets ``DriftSimulator.for_session`` manufactures from the seeds."""
    f = _port_fleet()
    f.calibrate()
    return f


def _replanned(src, **kw):
    """A cache-less port fleet holding ``src``'s tables."""
    f = _port_fleet(**kw)
    for d in range(2):
        for m in range(2):
            f.shard(d, m)._state = src.shard(d, m).calibration
    return f


def test_fleet_reads_the_reference_cache(fleets):
    f, jf = fleets["f"], fleets["jf"]
    assert f.device_ids == jf.device_ids == [["dimm0-d0m0", "dimm0-d0m1"],
                                             ["dimm0-d1m0", "dimm0-d1m1"]]
    assert all(st.cache_hit for row in fleets["states"] for st in row)
    for d in range(2):
        for m in range(2):
            s, js = f.shard(d, m), jf.shard(d, m)
            np.testing.assert_array_equal(s.calibration.masks.numpy(),
                                          np.asarray(js.calibration.masks))
            assert s.placement_status == "hit"
            assert s.placement_name == js.placement_name
            assert s.placement_name.startswith(f"{NAME}-shard{m}of2-")
            _assert_same(s.placement, js.placement)
    assert len({s.seed for row in f.sessions for s in row}) == 4


def test_fleet_packs_equal_reference(fleets):
    f, packs, jpacks = fleets["f"], fleets["packs"], fleets["jpacks"]
    assert f.shard_widths == fleets["jf"].shard_widths
    assert min(f.shard_widths) > 0
    for pm, jpm in zip(packs, jpacks):
        assert pm.placed and jpm.placed
        assert pm.packed_names == jpm.packed_names
        for name in pm.packed_names:
            _assert_same_sharded(pm.tensor(name), jpm.tensor(name))
    # shard m of every pack lives on the session (d, m)'s device
    st = packs[1].tensor("unembed/w")
    assert st.devices == tuple(s.device for s in f.sessions[1])


def test_replanned_placements_equal_reference(fleets):
    f = _replanned(fleets["f"])
    f.pack(fleets["params"], PUDGemvConfig(weight_bits=4), name=NAME)
    for d in range(2):
        for m in range(2):
            assert f.shard(d, m).placement_status == "planned"
            _assert_same(f.shard(d, m).placement,
                         fleets["jf"].shard(d, m).placement)


def test_lane_falls_back_to_logical_as_a_whole(fleets):
    """A live shard that cannot place (here: uncalibrated) makes its whole
    lane logical; the other lane stays placed.  The logical lane equals
    the reference's logical sharded pack."""
    f = _replanned(fleets["f"])
    f.shard(0, 1)._state = None
    packs = f.pack(fleets["params"], PUDGemvConfig(weight_bits=4), name=NAME)
    assert not packs[0].placed and packs[1].placed
    jpm = j_pack_sharded(fleets["jparams"], JGemvCfg(backend="reference"),
                         n_shards=2)
    for name in packs[0].packed_names:
        _assert_same_sharded(packs[0].tensor(name), jpm.tensor(name))


def test_recalibrate_shard_leaves_the_other_shard_untouched(fleets, own):
    f = _replanned(own)
    f.pack(fleets["params"], PUDGemvConfig(weight_bits=4), name=NAME)
    s0, s1 = f.sessions[0]
    state0, plc0 = s0._state, s0._placement
    lane1 = [(s._state, s._placement) for s in f.sessions[1]]
    levels1 = s1.calibration.levels.clone()
    pack_before = f.packs[0]
    sim = DriftSimulator.for_session(s1)
    sim.advance(temp_c=DRIFT_TEMP_C, subarrays=[3])
    pm = f.recalibrate_shard(1, [3], sim.sense_offsets(),
                             assumed_temp_c=DRIFT_TEMP_C)
    assert s0._state is state0 and s0._placement is plc0
    assert [(s._state, s._placement) for s in f.sessions[1]] == lane1
    after = s1.calibration.levels
    assert not torch.equal(after[3], levels1[3])
    assert torch.equal(after[:3], levels1[:3])
    assert f.packs[0] is pm and pm is not pack_before and pm.placed


def test_fleet_monitor_routes_events_to_the_owning_shard(fleets, own):
    f = _replanned(own)
    f.pack(fleets["params"], PUDGemvConfig(weight_bits=4), name=NAME)
    s0, s1 = f.sessions[0]
    sims = [DriftSimulator.for_session(s) for s in (s0, s1)]
    mon = FleetDriftMonitor(f, sims, config=DriftConfig(probe_every=1))
    assert not [e for e in mon.probe() if e.severity == "critical"]
    sims[1].advance(temp_c=DRIFT_TEMP_C, subarrays=[2])
    events = [e for e in mon.probe() if e.severity == "critical"]
    assert events and {e.shard for e in events} == {1}
    assert {e.subarray for e in events} == {2}
    state0 = s0._state
    pm = mon.recover(events[0])
    assert s0._state is state0 and f.packs[0] is pm
    rep = mon.report()
    assert rep["data_lane"] == 0 and len(rep["shards"]) == 2
    with pytest.raises(ValueError, match="one probe device per model shard"):
        FleetDriftMonitor(f, sims[:1])


def test_rate_models_and_batch_equal_reference(fleets):
    f, jf = fleets["f"], fleets["jf"]
    flops = 2 * j_get(ARCH).n_active_params
    assert f.optimal_batch_size() == jf.optimal_batch_size()
    rep, jrep = f.perf_report(flops, 4), jf.perf_report(flops, 4)
    for key in ("n_data", "n_model", "n_devices", "shard_widths",
                "batch_size"):
        assert rep[key] == jrep[key], key
    for key in ("shard_fraction", "aggregate_tok_s", "scaling_efficiency",
                "aggregate_batched_tok_s"):
        assert rep[key] == pytest.approx(jrep[key], rel=1e-12), key


def test_open_fleet_needs_a_mesh_or_both_axes():
    with pytest.raises(ValueError, match="open_fleet needs a mesh"):
        PUDSession.open_fleet(ARCH, n_data=2, device="cpu")
    with pytest.raises(ValueError, match="open_fleet needs a mesh"):
        JSession.open_fleet(ARCH, n_data=2)


def test_open_fleet_without_a_device_needs_a_gpu():
    if torch.cuda.is_available():
        f = PUDSession.open_fleet(ARCH, n_data=1, n_model=2)
        assert {s.device.type for s in f.sessions[0]} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PUDSession.open_fleet(ARCH, n_data=1, n_model=2)
