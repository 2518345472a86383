"""End-to-end parity of the port's serving slice with the JAX package on
the qwen3-1.7b smoke model (2 layers, d 64, vocab 256).

Weights come from the reference's ``init_params`` and cross over with
``from_numpy``, so both packages compute on identical bf16 weights.

Tolerances: logits are bf16-rounded values of magnitude < 5, where one bf16
ulp is 1/64 to 1/32.  XLA keeps float32 excess precision inside its fused
CPU kernels while PyTorch rounds every bf16 op, so activations differ by an
ulp here and there; measured teacher-forced logit differences stay under
0.025 on the bf16 path.  On the packed path an ulp in a bf16 activation can
also move one int8 activation step, and measured differences stay under
0.05.  The tests allow twice that: atol 0.05 (bf16) and 0.1 (packed).
Greedy tokens of the packed path are held identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as j_get  # noqa: E402
from repro.core.calibrate import CalibrationConfig as JCal  # noqa: E402
from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.launch.serve import greedy_generate as j_generate  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.runtime.session import PUDSession as JSession  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import (FleetConfig, load_or_calibrate,  # noqa: E402
                                    manufacture_fleet)
from repro_torch.launch.serve import greedy_generate, main  # noqa: E402
from repro_torch.models.params import from_numpy, init_params  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402
from repro_torch.runtime.session import PUDSession, _NullCache  # noqa: E402

ARCH, B, S, GEN = "qwen3-1.7b", 4, 16, 6
MAX_LEN = S + GEN + 1
ATOL_BF16, ATOL_PACKED = 0.05, 0.1


@pytest.fixture(scope="module")
def models():
    jmodel = j_get(ARCH).make_smoke()
    jparams = j_init(jmodel.param_defs(), jax.random.key(0))
    params = from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, get(ARCH).make_smoke(), params


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_param_tree_matches_reference(models):
    jmodel, jparams, model, params = models
    jl = dict(_leaves(jparams))
    own = dict(_leaves(init_params(model.param_defs(), 0, "cpu")))
    # the same leaves in the same order: packing requests follow tree order
    assert list(jl) == list(own) == list(dict(_leaves(params)))
    for path, t in _leaves(params):
        want = np.asarray(jl[path])
        assert tuple(t.shape) == want.shape == tuple(own[path].shape), path
        assert str(t.dtype).split(".")[-1] == want.dtype.name, path
        assert own[path].dtype == t.dtype, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      want.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_logits_allclose_teacher_forced(models, seed):
    """Prefill and six decode steps fed the same tokens in both packages."""
    jmodel, jparams, model, params = models
    toks, feed = _tokens(seed, (B, S)), _tokens(seed + 10, (GEN, B, 1))
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("max_len",))(
        jparams, jnp.asarray(toks), max_len=MAX_LEN)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks),
                                      max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_BF16)
    step = jax.jit(jmodel.decode_step)
    for i in range(GEN):
        jl, jc = step(jparams, jc, jnp.asarray(feed[i]), jnp.int32(S + i))
        with torch.inference_mode():
            logits, cache = model.decode_step(
                params, cache, torch.from_numpy(feed[i]), S + i)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL_BF16)
    np.testing.assert_allclose(cache["layers_0_dense"]["k"].float().numpy(),
                               np.asarray(jc["layers_0_dense"]["k"],
                                          np.float32), rtol=0, atol=0.05)


def test_session_reads_jax_cache_and_decodes_identically(models, tmp_path):
    """A reference session calibrates, places and persists; the port's
    session on the same directory hits the table and the placement, and
    its packed greedy decode equals the reference's token for token."""
    from test_torch_placement import _assert_same

    jmodel, jparams, model, params = models
    grid = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=512)
    name = f"{ARCH}-smoke"
    js = JSession.open(ARCH, grid=JFleet(**grid), cache_dir=tmp_path,
                       calib=JCal(n_iterations=12, n_samples=256),
                       key=jax.random.key(2), backend="reference")
    jst = js.calibrate()
    jpacked = js.pack(jparams, JGemvCfg(), name=name)
    assert not jst.cache_hit and js.placement_status == "planned"

    s = PUDSession.open(ARCH, grid=FleetConfig(**grid), cache_dir=tmp_path,
                        calib=CalibrationConfig(n_iterations=12,
                                                n_samples=256),
                        seed=2, device="cpu")
    st = s.calibrate()
    packed = s.pack(params, name=name)
    assert st.cache_hit and s.placement_status == "hit"
    assert s.placement_name == js.placement_name
    np.testing.assert_array_equal(st.masks.numpy(), np.asarray(jst.masks))
    _assert_same(s.placement, js.placement)
    s_replan = PUDSession.open(ARCH, grid=FleetConfig(**grid), seed=2,
                               device="cpu")
    s_replan._state = st
    s_replan.pack(params, name=name)
    assert s_replan.placement_status == "planned"
    _assert_same(s_replan.placement, js.placement)

    toks = _tokens(3, (B, S))
    jt, jl = j_generate(jmodel, jpacked.params, jnp.asarray(toks), GEN,
                        MAX_LEN)
    t, logits = greedy_generate(model, packed.params,
                                torch.from_numpy(toks), GEN, MAX_LEN)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_PACKED)
    extras = s.decode_extras()
    assert extras["layout"] == "placed physical" and extras["n_packed"] == 4


def test_serve_cli_miss_then_hit(tmp_path, capsys):
    argv = ["--preset", "smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "2", "--pud-gemv", "--calib-cache", str(tmp_path),
            "--fleet-subarrays", "8", "--fleet-cols", "512",
            "--device", "cpu"]
    assert main(argv) == 0
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "MISS (identified + persisted)" in out and "HIT (no" in out
    assert "planned + persisted" in out and "] HIT:" in out


def _open_session():
    return PUDSession.open(ARCH).device


def _manufacture():
    return manufacture_fleet(0, FleetConfig(n_subarrays=1, n_cols=256),
                             PhysicsParams()).device


def _load_or_calibrate():
    grid = FleetConfig(n_channels=1, n_banks=1, n_subarrays=1, n_cols=256)
    return load_or_calibrate(_NullCache(), "dimm0", 0, grid,
                             config=CalibrationConfig(n_iterations=1,
                                                      n_samples=8),
                             n_trials_ecr=8)[0].device


def _evaluate_method():
    from repro_torch.core.throughput import evaluate_method
    return evaluate_method(0, "B300", n_cols=256, n_trials_maj5=8,
                           with_arith=False).error_free_mask.device


def _make_subarray():
    from repro_torch.pud.device import make_subarray
    return make_subarray(torch.Generator(), 8, 256,
                         PhysicsParams()).charge.device


@pytest.mark.parametrize("entry", [_open_session, _manufacture,
                                   _load_or_calibrate, _evaluate_method,
                                   _make_subarray])
def test_session_without_device_needs_a_gpu(entry):
    """Every entry point defaults to the GPU and raises without one."""
    if torch.cuda.is_available():
        assert entry().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def _chip_smoke():
    import importlib.util
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_rehearses_on_cpu(capsys):
    """The chip script's phases, on the CPU at smoke size through the plain
    versions: every check passes and every kernel row is complete."""
    from repro_torch.core.calibrate import CalibrationConfig
    cs = _chip_smoke()
    out = cs.run(torch, torch.device("cpu"), preset="smoke",
                 grid=dict(n_channels=1, n_banks=1, n_subarrays=8,
                           n_cols=512),
                 table1=dict(n_cols=1024, n_trials_maj5=256,
                             n_cols_arith=64, n_trials_arith=64),
                 table1_calib=CalibrationConfig(n_iterations=8,
                                                n_samples=128),
                 quickstart=dict(n_channels=1, n_banks=1, n_subarrays=2,
                                 n_cols=512),
                 simra=dict(n_cols=2048, events=64),
                 dense_cfg=dict(b=4, k=256, n=512, wb=4),
                 sense_shapes=[(1, 8, 2048, 3), (16, 8, 512, 0),
                               (3, 5, 100, 3)])
    names = [r["name"] for r in out["rows"]]
    assert names == ["calib_iter", "gemm_placed", "gemv_placed", "gemm",
                     "gemv", "majx_sense"]
    t1 = out["table1"]
    assert t1["T210"]["ecr"] < t1["B300"]["ecr"]
    assert out["quickstart"]["tuned"] < out["quickstart"]["baseline"]
    assert abs(out["simra"]["ecr_cmd"] - out["simra"]["ecr_fast"]) \
        <= out["simra"]["tol"]
    for r in out["rows"][1:5]:           # the dense layout on every entry
        assert [e["layout"] for e in r["extra_shapes"]][-2:] == ["dense"] * 2
    for r in out["rows"]:
        for e in [r] + r.get("extra_shapes", []):
            assert e["max_abs_err"] == 0 and e["bound_ms"] > 0
            assert e["bound_by"] in ("bytes", "operations")
    text = capsys.readouterr().out
    assert "placement HIT" in text and "bit for bit" in text
    assert "gains T210/B300" in text and "command level" in text
    assert "unplaced engine path" in text and "100.0% of requests" in text
    assert "plan: dp4a" in text and "plan: tensor cores" in text


def test_chip_smoke_fails_without_gpu_or_sources(tmp_path):
    import shutil
    import subprocess
    import sys
    cs = _chip_smoke()
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    if not torch.cuda.is_available():
        assert cs.main() != 0
