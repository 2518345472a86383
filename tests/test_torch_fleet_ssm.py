"""The SSM family on the sharded fleet: mamba2-1.3b's smoke config (float32,
vocab widened to 512 so both model shards of the packed unembed own
columns) on (data 2, model 2) CPU positions, placed and logical, against
a single-device ``ServingEngine`` over the unsharded logical pack of the
same weights (the reference's): every lane's tokens and logits equal,
bit for bit, with the lane's requests in its order on as many slots; and
its tokens equal the reference's single-device engine's.  ``serve
--mesh`` serves mamba2 and refuses the hybrid as its engine does; the
encoder-decoder keeps the reference's skip."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.configs import get as j_get  # noqa: E402
from repro.models.params import init_params as j_init  # noqa: E402
from repro.pud.gemv import PUDGemvConfig as JGemvCfg  # noqa: E402
from repro.pud.packer import pack_model as j_pack_model  # noqa: E402
from repro.runtime.engine import Request as JRequest  # noqa: E402
from repro.runtime.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.pud.gemv import PUDGemvConfig  # noqa: E402
from repro_torch.pud.packer import pack_model  # noqa: E402
from repro_torch.runtime.engine import Request, ServingEngine  # noqa: E402
from repro_torch.runtime.session import PUDSession  # noqa: E402

ARCH = "mamba2-1.3b"
MAX_LEN, GEN, PROMPT, SLOTS = 16, 4, 8, 2
GRID = dict(n_channels=1, n_banks=1, n_subarrays=4, n_cols=512)


@pytest.fixture(scope="module")
def setup():
    jm = j_get(ARCH).make_smoke()
    jm = type(jm)(dataclasses.replace(jm.cfg, vocab=512, dtype=jnp.float32))
    model = get(ARCH).make_smoke()
    model = type(model)(dataclasses.replace(model.cfg, vocab=512,
                                            dtype=torch.float32))
    jp = jax.tree.map(np.asarray, j_init(jm.param_defs(), jax.random.key(0)))
    params = from_numpy(jp, "cpu")
    prompts = np.random.default_rng(1).integers(0, 512, (4, PROMPT)).astype(
        np.int32)
    jref = JEngine(jm, j_pack_model(jax.tree.map(jnp.asarray, jp),
                                    JGemvCfg(backend="reference")).params,
                   max_len=MAX_LEN, batch_size=SLOTS)
    ref = {c.request_id: list(np.asarray(c.tokens)) for c in jref.run(
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
        f.pack(params, PUDGemvConfig(weight_bits=4), name=f"ssm-{placed}")
        fleets[placed] = f
    return dict(model=model, params=params, prompts=prompts, ref=ref,
                fleets=fleets)


def _requests(prompts, ids):
    return [Request(request_id=i, tokens=torch.from_numpy(prompts[i]),
                    max_new_tokens=GEN) for i in ids]


@pytest.mark.parametrize("placed", [True, False], ids=["placed", "logical"])
def test_mamba2_fleet_equals_single_device_engine(setup, placed):
    model, f = setup["model"], setup["fleets"][placed]
    assert all(pm.placed == placed for pm in f.packs)
    un = f.packs[0].tensor("unembed/w")
    assert un.n_shards == 2 and all(w > 0 for w in un.shard_widths)
    eng = f.serving_engine(model, max_len=MAX_LEN, batch_size=SLOTS,
                           collect_logits=True)
    comps = eng.run(_requests(setup["prompts"], range(4)))
    assert [c.request_id for c in comps] == [0, 1, 2, 3]
    assert all(c.tokens == setup["ref"][c.request_id] for c in comps)
    logical = pack_model(setup["params"], PUDGemvConfig(weight_bits=4))
    for d, lane in enumerate(eng.lanes):
        ids = [c.request_id for c in lane._completions]
        assert ids == [i for i in range(4) if i % 2 == d]
        single = ServingEngine(model, logical.params, max_len=MAX_LEN,
                               batch_size=SLOTS, collect_logits=True)
        for c, w in zip(sorted(lane._completions,
                               key=lambda c: c.request_id),
                        single.run(_requests(setup["prompts"], ids))):
            assert c.tokens == w.tokens
            assert torch.equal(c.logits, w.logits)


def _serve(arch, tmp_path, capsys):
    serve.main(["--arch", arch, "--preset", "smoke", "--batch", "4",
                "--prompt-len", "8", "--gen", "2", "--pud-gemv", "--engine",
                "--mesh", "2,2", "--batch-size", "2", "--calib-cache",
                str(tmp_path), "--fleet-subarrays", "2", "--fleet-cols",
                "512", "--device", "cpu"])
    return capsys.readouterr().out


def test_serve_mesh_serves_mamba2(tmp_path, capsys):
    out = _serve(ARCH, tmp_path, capsys)
    assert "fleet mesh 2x2 (data x model), 4 logical devices" in out
    assert "fleet engine: 4 requests over 2 lanes" in out
    assert "skipping" not in out


@pytest.mark.parametrize("arch,why", [
    ("zamba2-7b", "the continuous-batching engine needs the batch on "
     "axis 1"),
    ("whisper-large-v3", "fleet: vlm/encdec families not supported yet")])
def test_serve_mesh_refuses_as_the_engine_does(arch, why, tmp_path, capsys):
    out = _serve(arch, tmp_path, capsys)
    assert why in out and "skipping" in out
    assert "fleet mesh" not in out
