"""The session surface of the port against the reference's: the pinned
operating points and their rates, the cross-shard aggregate, the MVDRAM
serving table, ``PUDSession.linear`` and the backend registry.

Tolerances: the rate models are host arithmetic on the same doubles, held
to a relative 1e-12 (they agree to the last bit or nearly); ``linear``
through the ``reference`` backend is exact (int32 accumulators and the
float32 dequant in the same order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.kernels.backends import get_backend as j_backend  # noqa: E402
from repro.kernels.ops import quantize_activations as j_quant  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.pud.gemv import FleetPerfAggregate as JAgg  # noqa: E402
from repro.pud.gemv import FleetPerfModel as JFleetPerf  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import all_archs, get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.kernels import backends, ops  # noqa: E402
from repro_torch.kernels.autotune import TunedPlan  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.pud.gemv import (ATTN_PACKABLE, ECR_BASELINE_B300,  # noqa: E402
                                  ECR_PUDTUNE_T210, FFN_PACKABLE,
                                  FleetPerfAggregate, FleetPerfModel,
                                  PUDGemvConfig)
from repro_torch.runtime.session import PUDSession  # noqa: E402

ARCH = "qwen3-1.7b"
REL = 1e-12


def _close(a, b):
    assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0), (a, b)


def _models(n_fracs=3):
    tables = ([0.033], [0.02, 0.05, 0.031, 0.04], [0.466] * 3)
    return [(JFleetPerf.from_table(t, n_fracs=n_fracs),
             FleetPerfModel.from_table(t, n_fracs=n_fracs)) for t in tables]


@pytest.mark.parametrize("widths", [None, (256, 256, 0), (512, 256, 256),
                                    (1024, 1024, 768)])
@pytest.mark.parametrize("n_data", [1, 3])
def test_fleet_perf_aggregate_equals_reference(widths, n_data):
    pairs = _models()
    jagg = JAgg(shards=tuple(j for j, _ in pairs), n_data=n_data,
                shard_widths=widths)
    agg = FleetPerfAggregate(shards=tuple(p for _, p in pairs),
                             n_data=n_data, shard_widths=widths)
    assert (agg.n_model, agg.n_devices) == (jagg.n_model, jagg.n_devices)
    _close(agg.shard_fraction, jagg.shard_fraction)
    for flops in (2 * 2.03e9, 2 * 67.4e9):
        _close(agg.tokens_per_second(flops), jagg.tokens_per_second(flops))
        for b in (1, 2, 4, 9):
            _close(agg.batched_tokens_per_second(flops, b),
                   jagg.batched_tokens_per_second(flops, b))
            _close(agg.step_seconds(flops, b), jagg.step_seconds(flops, b))
            _close(agg.scaling_efficiency(flops, b),
                   jagg.scaling_efficiency(flops, b))
        rep, jrep = agg.report(flops, 2), jagg.report(flops, 2)
        assert rep.keys() == jrep.keys()
        for k in rep:
            _close(float(rep[k]), float(jrep[k]))


def test_from_table_rounds_as_the_reference_does():
    """Python floats subtract in float64, a float32 table in float32."""
    for table in ([0.033, 0.466], np.array([0.033, 0.466], np.float32)):
        j = JFleetPerf.from_table(table)
        p = FleetPerfModel.from_table(torch.as_tensor(table)
                                      if isinstance(table, np.ndarray)
                                      else table)
        assert p.error_free_fracs == j.error_free_fracs


@pytest.mark.parametrize("arch", [ARCH, "gemma-7b", None])
@pytest.mark.parametrize("ecr", [ECR_BASELINE_B300, ECR_PUDTUNE_T210, 0.1])
def test_at_operating_point_prices_as_the_reference(arch, ecr):
    j = JSession.at_operating_point(ecr, arch=arch)
    s = PUDSession.at_operating_point(ecr, arch=arch, device="cpu")
    flops = 2 * get(arch or ARCH).n_active_params
    assert flops == 2 * j_get(arch or ARCH).n_active_params
    _close(s.tokens_per_second(flops), j.tokens_per_second(flops))
    if arch is not None:
        _close(s.tokens_per_second(), j.tokens_per_second())
    else:
        with pytest.raises(ValueError):
            s.tokens_per_second()
    rep, jrep = s.perf_report(flops, batch_size=4), \
        j.perf_report(flops, batch_size=4)
    for k in ("mean_ecr", "gain", "baseline_tok_s", "tuned_tok_s",
              "optimal_batch", "n_fracs", "calibrated"):
        assert (rep[k] == jrep[k] if isinstance(rep[k], (bool, int))
                else math.isclose(rep[k], jrep[k], rel_tol=REL)), k
    assert rep["mean_ecr"] == ecr and not rep["calibrated"]
    assert s.optimal_batch_size() == j.optimal_batch_size() == 1


def test_mvdram_serving_rows_equal_reference():
    """The port's rows for the archs it registers equal the reference
    benchmark's rows for the same archs, column for column."""
    from benchmarks.mvdram_serving import run as j_run
    from repro_torch.benchmarks.mvdram_serving import run
    want = {r["arch"]: r for r in j_run()}
    rows = run(device="cpu")
    assert [r["arch"] for r in rows] == list(all_archs())
    assert {r["arch"] for r in rows} <= set(want)
    for r in rows:
        w = want[r["arch"]]
        assert list(r) == list(w)
        for k, v in r.items():
            if isinstance(v, str) or isinstance(v, int):
                assert v == w[k], (r["arch"], k)
            else:
                assert math.isclose(v, w[k], rel_tol=REL), (r["arch"], k)


@pytest.fixture(scope="module")
def weights():
    jmodel = j_get(ARCH).make_smoke()
    jparams = j_init(jmodel.param_defs(), jax.random.key(0))
    return jparams, from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _x(seed=3, rows=3, d=64):
    return np.random.default_rng(seed).standard_normal(
        (rows, d)).astype(np.float32)


@pytest.mark.parametrize("placed", [False, True])
def test_linear_equals_reference(weights, tmp_path, placed):
    """``PUDSession.linear`` on the same weights and inputs as the
    reference's, through the ``reference`` backend: float32 outputs equal,
    and the int32 accumulators of the projection equal."""
    jparams, params = weights
    grid = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=512)
    kw = dict(cache_dir=tmp_path) if placed else {}
    js = JSession.open(ARCH, grid=JFleet(**grid), backend="reference",
                       calib=JCal(n_iterations=8, n_samples=128),
                       key=jax.random.key(2), **kw)
    s = PUDSession.open(ARCH, grid=FleetConfig(**grid), backend="reference",
                        calib=CalibrationConfig(n_iterations=8,
                                                n_samples=128),
                        seed=2, device="cpu", **kw)
    if placed:
        js.calibrate()
        assert s.calibrate().cache_hit
    cfg = (FFN_PACKABLE + ATTN_PACKABLE)
    js.pack(jparams, JGemvCfg(packable=cfg), name="m")
    s.pack(params, PUDGemvConfig(packable=cfg), name="m")
    # placed: the port reads the reference's persisted table and plan
    assert (s.placement_status, js.placement_status) == \
        (("hit", "planned") if placed else (None, None))
    x = _x()
    for name in ("unembed/w",):
        got = s.linear(torch.from_numpy(x), name)
        want = js.linear(jnp.asarray(x), name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        pt, jpt = s.packed.tensor(name), js._packed.tensor(name)
        xq, _ = ops.quantize_activations(torch.from_numpy(x))
        jxq, _ = j_quant(jnp.asarray(x))
        np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
        kw = dict(layout=pt.layout, logical_k=pt.logical_k)
        be, jbe = backends.get_backend("reference"), j_backend("reference")
        if pt.placed:
            acc = be.matmul_placed(xq, pt.planes, pt.col_ids,
                                   window_block=pt.window_block, **kw)
            jacc = jbe.matmul_placed(jxq, jpt.planes, jpt.col_ids,
                                     window_block=jpt.window_block, **kw)
        else:
            acc = be.matmul(xq, pt.planes, **kw)
            jacc = jbe.matmul(jxq, jpt.planes, **kw)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    # one row (the GEMV entry) and a leading batch shape
    one = s.linear(torch.from_numpy(x[:1]), "unembed/w")
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(js.linear(jnp.asarray(x[:1]), "unembed/w")))
    lead = s.linear(torch.from_numpy(x).reshape(3, 1, 64), "unembed/w")
    assert lead.shape == (3, 1, 256)


def test_linear_and_tune_need_a_pack_and_tune_needs_the_gpu(weights):
    _, params = weights
    s = PUDSession.open(ARCH, device="cpu")
    assert s.tuning_report() is None
    with pytest.raises(RuntimeError, match="pack"):
        s.linear(torch.zeros(1, 64), "unembed/w")
    with pytest.raises(RuntimeError, match="pack"):
        s.tune()
    s.pack(params)
    with pytest.raises(RuntimeError, match="needs the GPU"):
        s.tune(batches=(1, 4))
    assert s.tuning_report() is None


def test_linear_runs_the_stamped_plan_and_raises_on_a_rejected_one(weights):
    _, params = weights
    s = PUDSession.open(ARCH, device="cpu")
    s.pack(params)
    x = torch.from_numpy(_x(rows=4))
    base = s.linear(x, "unembed/w")
    pt = s.packed.tensor("unembed/w")
    s._restamp_packs({"unembed/w": pt.replace(tile_plan=(
        ("gemm", TunedPlan(rows=16, n_split=1)),))})
    assert s.packed.tensor("unembed/w").tile_plan is not None
    assert torch.equal(s.linear(x, "unembed/w"), base)
    s._restamp_packs({"unembed/w": pt.replace(tile_plan=(
        ("gemm", TunedPlan(rows=3)),))})
    with pytest.raises(ValueError, match="rows-instantiated"):
        s.linear(x, "unembed/w")
    assert torch.equal(s.linear(x[:1], "unembed/w"), base[:1])   # no GEMV plan


def test_backend_registry_and_matmul_fallback():
    calls = []

    def gemv(x, planes, mode="folded", **kw):
        calls.append(("gemv", x.shape[0]))
        return backends.get_backend("reference").gemv(x, planes, mode, **kw)

    be = backends.Backend("gemv-only", gemv=gemv,
                          gemv_placed=backends.get_backend(
                              "reference").gemv_placed,
                          majx_sense=None, calib_iter=None)
    assert be.gemm is None and be.gemm_placed is None
    try:
        backends.register_backend(be)
        with pytest.raises(ValueError, match="already registered"):
            backends.register_backend(be)
        assert "gemv-only" in backends.backend_names()
        w = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
        from repro_torch.pud.gemv import pack_linear
        pt = pack_linear(w, 4)
        x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
        kw = dict(layout=pt.layout, logical_k=pt.logical_k)
        got = ops.pud_matmul(x, pt.planes, pt.scale, backend="gemv-only",
                             **kw)
        want = ops.pud_matmul(x, pt.planes, pt.scale, backend="reference",
                              **kw)
        assert torch.equal(got, want) and calls == [("gemv", 4)]
    finally:
        backends._REGISTRY.pop("gemv-only", None)
    with pytest.raises(ValueError, match="already registered"):
        backends.register_backend(backends.get_backend("cuda"))
