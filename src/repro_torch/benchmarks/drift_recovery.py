"""Beyond the paper: online drift recovery — detection latency, recalibration
scope and hot swap without a stalled step on the serving engine (port of
``benchmarks/drift_recovery.py``).

The paper calibrates once and holds the table fixed; this benchmark ages the
device mid-serve (``core/reliability.DriftSimulator``, far past the paper's
drift envelope so detection is certain) and measures the whole
``runtime/drift.py`` loop:

  * **detection latency**: engine steps from the drift epoch to the canary
    probes raising a critical event (the probe cadence bounds it),
  * **recovery scope**: only the drifted subarrays are re-identified,
  * **zero downtime**: tokens emitted on every step, the swap step
    included.  The run FAILS if a step with live requests stalls, if no
    recovery happens, if it touches other subarrays, or if post-swap decode
    diverges from a fresh decode on the recovered pack.

Host walls gauge the scheduler, not DRAM; the probe cost is priced by the
wave-latency model the serving rates come from (``probe_overhead``).  Runs
at its own smoke configuration (``--full`` changes nothing).  With
``BenchScale.check_plain`` the run is repeated on the plain PyTorch
versions and must give the same row, tables, tokens and logits.

    python -m repro_torch.benchmarks.drift_recovery [--device cpu]
"""
from __future__ import annotations

import torch

from repro_torch.configs import get
from repro_torch.core.calibrate import CalibrationConfig
from repro_torch.core.fleet import FleetConfig
from repro_torch.core.reliability import DriftSimulator
from repro_torch.core.rng import generator
from repro_torch.launch.serve import greedy_generate
from repro_torch.models.params import init_params
from repro_torch.pud.gemv import PUDGemvConfig
from repro_torch.runtime.drift import (DriftConfig, DriftController,
                                       DriftMonitor, run_with_drift,
                                       sim_read_faults)
from repro_torch.runtime.engine import Request
from repro_torch.runtime.session import PUDSession

from .common import emit, hold_to_plain, parse_scale, plain_backend

ARCH = "qwen3-1.7b"
N_REQUESTS = 8
PROMPT_LEN = 8
GEN = 4
MAX_LEN = PROMPT_LEN + GEN + 1
DRIFT_AT = 3                 # engine step of the drift epoch
DRIFT_TEMP_C = 3000.0        # stress temperature (see module docstring)
DRIFT_SUBARRAYS = (1, 5)
PROBE_EVERY = 2
SEED = 3


def _session(device, plain: bool) -> PUDSession:
    s = PUDSession.open(
        ARCH,
        grid=FleetConfig(n_channels=1, n_banks=1, n_subarrays=8,
                         n_cols=1024),
        calib=CalibrationConfig(n_iterations=6, n_samples=128),
        seed=11, n_trials_ecr=256, device=device, **plain_backend(plain))
    s.calibrate()
    return s


def run(scale=None, device=None) -> dict:
    return _run(device, plain=False)[0]


def _run(device, plain: bool) -> tuple[dict, dict]:
    """The benchmark on the kernels or (``plain``) the plain PyTorch
    versions: its row, and what the kernels computed (the table's levels
    before and after the recovery, every request's tokens and logits)."""
    session = _session(device, plain)
    dev = session.device
    model = get(ARCH).make_smoke()
    params = init_params(model.param_defs(), 0, dev)

    session.reserve_canaries(16)
    session.pack(params, PUDGemvConfig(weight_bits=4), name="drift-bench")
    ecr_before = session.calibration.ecr.cpu().numpy().copy()
    levels_before = session.calibration.levels.clone()

    engine = session.serving_engine(model, max_len=MAX_LEN, batch_size=2,
                                    collect_logits=True)
    sim = DriftSimulator.for_session(session)
    monitor = DriftMonitor(session, sim,
                           config=DriftConfig(probe_every=PROBE_EVERY))
    ctl = DriftController(engine, monitor, params, pack_name="drift-bench",
                          read_faults=sim_read_faults(session, sim))

    prompts = [torch.randint(0, model.cfg.vocab, (PROMPT_LEN,),
                             generator=generator(SEED, "prompt", i,
                                                 device=dev),
                             device=dev, dtype=torch.int32)
               for i in range(N_REQUESTS)]
    try:
        run_with_drift(
            ctl, [Request(request_id=i, tokens=p, max_new_tokens=GEN)
                  for i, p in enumerate(prompts[:N_REQUESTS - 2])],
            sim, at=DRIFT_AT, temp_c=DRIFT_TEMP_C,
            subarrays=DRIFT_SUBARRAYS, seed=SEED, n_trials=256,
            max_ticks=64 * N_REQUESTS)
    except RuntimeError as e:
        raise AssertionError("drift recovery loop did not converge") from e

    rep = ctl.report()
    if not rep["recoveries"]:
        raise AssertionError("drift was injected but no recovery happened")
    rec = rep["recoveries"][0]
    if sorted(rec["subarrays"]) != sorted(DRIFT_SUBARRAYS):
        raise AssertionError(
            f"recovery touched {rec['subarrays']}, "
            f"expected exactly {sorted(DRIFT_SUBARRAYS)}")
    if not rep["swap_step_tokens"] or min(rep["swap_step_tokens"]) == 0:
        raise AssertionError(
            f"hot swap stalled the engine: tokens on swap steps = "
            f"{rep['swap_step_tokens']}")
    if rep["min_tokens_per_step"] == 0:
        raise AssertionError("a step with live requests emitted no tokens")

    # post-swap decode must match a fresh decode on the recovered pack
    post = [Request(request_id=100 + i, tokens=p, max_new_tokens=GEN)
            for i, p in enumerate(prompts[N_REQUESTS - 2:])]
    done = ctl.run(post)
    comps = {c.request_id: c for c in done}
    fresh = session.packed.params
    for r in post:
        want, _ = greedy_generate(model, fresh, r.tokens[None, :], GEN,
                                  MAX_LEN)
        if comps[r.request_id].tokens != want[0].tolist():
            raise AssertionError(
                f"post-swap request {r.request_id} diverged from the "
                "fresh-pack decode")

    ecr_after = session.calibration.ecr.cpu().numpy()
    computed = {"levels_before": levels_before,
                "levels_after": session.calibration.levels,
                "tokens": [c.tokens for c in done],
                "logits": [c.logits for c in done]}
    return {
        "drift_step": DRIFT_AT,
        "drift_subarrays": sorted(DRIFT_SUBARRAYS),
        "detected_step": rec["detected_step"],
        "detection_latency_steps": rec["detected_step"] - DRIFT_AT,
        "canary_ecr_at_detection": rec["canary_ecr_at_detection"],
        "swap_step": rec["swap_staged_step"],
        "swap_step_tokens": rep["swap_step_tokens"],
        "min_tokens_per_step": rep["min_tokens_per_step"],
        "ecr_before": {g: float(ecr_before[g]) for g in DRIFT_SUBARRAYS},
        "ecr_after": {g: float(ecr_after[g]) for g in DRIFT_SUBARRAYS},
        "probe_overhead": rep["probe_overhead"],
        "probe_rounds": rep["probe_rounds"],
        "steps": rep["ticks"],
    }, computed


def report(scale=None, device=None) -> None:
    row, computed = _run(device, plain=False)
    if scale is not None and scale.check_plain:
        hold_to_plain("drift_recovery", (row, computed),
                      _run(device, plain=True))
    emit("drift_recovery", [row],
         header=f"{ARCH} smoke, drift at step {row['drift_step']} on "
                f"subarrays {row['drift_subarrays']}, probe every "
                f"{PROBE_EVERY} steps")
    print("Online drift recovery (canary detect -> partial recal -> hot "
          "swap):")
    print(f"  drift injected at step {row['drift_step']} "
          f"(subarrays {row['drift_subarrays']}, {DRIFT_TEMP_C:.0f}C)")
    det = ", ".join(f"g{g}: {e:.3f}"
                    for g, e in row["canary_ecr_at_detection"].items())
    print(f"  detected at step {row['detected_step']} "
          f"(+{row['detection_latency_steps']} steps; canary ECR {det})")
    for g in row["drift_subarrays"]:
        print(f"  subarray {g}: table ECR {row['ecr_before'][g]:.3f} "
              f"before -> {row['ecr_after'][g]:.3f} after recalibration")
    print(f"  hot swap at step {row['swap_step']}: "
          f"{row['swap_step_tokens']} tokens on swap step(s), "
          f"min {row['min_tokens_per_step']} tokens/step overall")
    print(f"  probe cost: {row['probe_rounds']} rounds, modeled overhead "
          f"{row['probe_overhead']:.2%} of DRAM time")
    print("  post-swap decode bit-identical to fresh pack: OK")


def main(argv=None) -> int:
    report(*parse_scale(argv, description=__doc__))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
