"""Smoke-size runs of a cell's configuration on the CPU, through the
port's own path (its plain kernel versions): the overrides a test passes
to ``harness.cell.run``, and a closed-loop engine run whose logits the
engine keeps."""
import tempfile

import torch

from pudbench.harness import cell, check, spec, weights
from pudbench.harness.loop import ClosedLoop
from pudbench.harness.traffic import Traffic

OVERRIDES = {
    "smoke": True,
    "mix": {"clients": 4, "pool": 32,
            "prompt": {"median": 16, "sigma": 0.5, "min": 8, "max": 32},
            "output": {"median": 6, "sigma": 0.3, "min": 4, "max": 10}},
    "workload": {"warmup_steps": 2, "compare_requests": 64,
                 "window_steps": 24},
    "grid": {"n_subarrays": 8, "n_cols": 512},
}


def served(cell_name: str, seed: int, steps: int = 12):
    """(sizes, weights, traffic, completions with logits, waves) of a
    smoke-size closed loop of 4 clients through the port on the CPU."""
    from repro_torch.configs import registry
    from repro_torch.core.calibrate import CalibrationConfig
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.pud.gemv import PUDGemvConfig
    from repro_torch.runtime.engine import Request
    from repro_torch.runtime.session import PUDSession

    c = spec.load_cell(cell_name)
    config = c.config
    model = registry.get(config["port"]["arch"]).make_smoke()
    sizes = cell._keys_as_run(config, model)
    params = weights.make(model.param_defs(), seed, "cpu")
    mix = dict(c.mix, **OVERRIDES["mix"])
    traffic = Traffic(mix, sizes[config["port"]["vocab_key"]], seed)
    with tempfile.TemporaryDirectory() as tmp:
        session = PUDSession.open(
            config["port"]["arch"],
            grid=FleetConfig(**dict(config["grid"], **OVERRIDES["grid"])),
            calib=CalibrationConfig(**config["calibration"]),
            cache_dir=tmp, seed=seed, device="cpu")
        session.calibrate()
        session.pack(params, PUDGemvConfig(
            weight_bits=4, packable=tuple(config["pud"]["packable"])))
        engine = session.serving_engine(
            model, max_len=traffic.max_prompt + traffic.max_output,
            batch_size=4, max_batch=4, collect_logits=True)
        loop = ClosedLoop(engine, traffic, Request)
        loop.start()
        for i in range(steps):
            loop.step(until=0.0 if i == steps - 1 else None)
        waves = engine.scheduler_report()["steps"]
        loop.close()
    return config, sizes, params, traffic, loop.completions, waves


def reference_logits(config, sizes, params, traffic, completions, waves):
    done = sorted(k for k, c in completions.items() if not c.shed)
    job = check.job_for(config, traffic, completions, waves, done)
    with torch.inference_mode():
        return check.reference(config).logits(sizes, params, job, "bf16")
