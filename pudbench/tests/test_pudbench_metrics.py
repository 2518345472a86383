"""The metric arithmetic on synthetic inputs: percentiles over all
samples, window rates, the spread, FLOP and byte counts, the trace's busy
and idle time, and shares of a peak or a roofline that stay at or under
100% where the work fits the time."""
import statistics

import numpy as np
import pytest

from pudbench.harness import counts, spec, stats
from pudbench.harness.loop import Step, Window
from pudbench.harness.peaks import PEAKS
from pudbench.harness.trace import Trace, breakdown, busy_seconds

H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def _cfg(name):
    return spec.as_run(spec.load_json("configs", name))


def test_percentile_is_numpys_linear():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=137)
    for q in (50, 90, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert stats.percentile([], 90) is None


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 9.5, 10.2, 10.8, 9.9]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def _window():
    steps = [Step(start=0.1 * i, end=0.1 * i + 0.09, admitted=i % 2,
                  live=4) for i in range(10)]
    return Window(t0=0.0, t1=0.99, steps=steps, ttft=[0.05, 0.2, 0.1],
                  itl=[0.1] * 30 + [0.0] * 5, tokens=45, admitted=5,
                  report0={"steps": 10, "slot_occupancy": 1.0,
                           "decode_wall_s": 0.5, "batch_size": 4},
                  report1={"steps": 20, "slot_occupancy": 0.95,
                           "decode_wall_s": 1.2, "batch_size": 4})


def test_window_rates():
    run = {"window": _window(), "batch": 4, "setup_s": 12.5,
           "spans": {"calibrate": 0.4, "pack": 2.0}, "stretch": None}
    read = lambda n: spec.load_metric(n).read(run)  # noqa: E731
    assert read("gen_tok_s") == pytest.approx(45 / 0.99)
    assert read("ttft_p90_ms") == pytest.approx(
        1e3 * np.percentile([0.05, 0.2, 0.1], 90))
    assert read("itl_p95_ms") == pytest.approx(100.0)
    assert read("setup_s") == 12.5
    assert read("calibration.calibrate_s") == 0.4
    assert read("placement.pack_s") == 2.0
    # 20 x 0.95 x 4 - 10 x 1.0 x 4 = 36 live rows over 10 steps of 4
    assert read("engine.slot_occupancy") == pytest.approx(90.0)
    assert read("model.decode_wave_ms") == pytest.approx(70.0)
    # step walls 10 x 0.09 s less 0.7 s of decode, over 5 admissions
    assert read("engine.admit_ms") == pytest.approx(1e3 * 0.2 / 5)


def test_deepseek_flops_per_token():
    c = _cfg("deepseek-v2-lite-16b")
    attn = (2048 * 16 * 192 + 2048 * 512 + 2048 * 64 + 512 * 16 * 256
            + 16 * 128 * 2048)
    moe = 2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816
    per = 2 * (27 * attn + 3 * 2048 * 10944 + 26 * moe)
    assert counts.model_flops(c, decode_positions=[0]) == pytest.approx(
        per + 2 * 2048 * 102400 + 2 * 27 * 16 * (512 + 64 + 512))
    # about 2.4 B active parameters a token, besides the embeddings
    assert 2.0e9 < per / 2 < 2.6e9


def test_mamba2_flops_per_token():
    c = _cfg("mamba2-1.3b")
    per = counts.model_flops(c, prompts=[1]) - 2 * 2048 * 50280
    # 1.3 B parameters less the embedding and unembed (2 x 103 M)
    assert 1.0e9 < per / 2 < 1.3e9


def test_placed_call_bytes_and_ops():
    call = counts.placed_call(64, 2048, 10944, 4)
    assert call["ops"] == 2 * 64 * 2048 * 10944
    assert call["bytes"] == (10944 * 4 * 256 + 4 * 10944 + 64 * 2048
                             + 4 * 64 * 10944)
    # a decode GEMM is bound by its bytes, a long prefill by its operations
    assert counts.least_seconds(call, H100) == pytest.approx(
        call["bytes"] / H100["hbm_bytes_s"])
    big = counts.placed_call(4096, 2048, 10944, 4)
    assert counts.least_seconds(big, H100) == pytest.approx(
        big["ops"] / H100["int8_ops"])


def _trace():
    k = [("void dp4a_kernel<4, false>(signed char const*)", 1.0, 1.2),
         ("void mma_kernel<2, false>(signed char const*)", 1.3, 1.5),
         ("void plane_mma_kernel<2>(...)", 1.55, 1.6),
         ("ampere_bf16_gemm", 1.1, 1.25), ("elementwise", 2.0, 2.5)]
    spans = [("stretch", 0.5, 3.0), ("engine.step", 0.6, 2.6),
             ("client loop", 2.6, 2.9)]
    return Trace(kernels=k, spans=spans, stretch=(0.5, 3.0))


def test_trace_busy_idle_and_breakdown():
    tr = _trace()
    # overlapping intervals count once: 0.25 + 0.2 + 0.05 + 0.5
    assert busy_seconds(tr.kernels, *tr.stretch) == pytest.approx(1.0)
    run = {"trace": tr}
    idle = spec.load_metric("device.idle").read(run)
    assert idle == pytest.approx(100 * (1 - 1.0 / 2.5))
    b = breakdown(tr)
    assert b["device_ops"][0] == ["elementwise", pytest.approx(0.5)]
    assert b["idle_gaps"][0][0] == "engine.step"
    assert b["idle_gaps"][0][1] == pytest.approx(0.5)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert {g[0] for g in b["idle_gaps"]} <= {"engine.step", "client loop"}


def test_roofline_and_mfu_stay_under_100_where_the_work_fits():
    cfg = _cfg("deepseek-v2-lite-16b")
    packs = [("layers_0_dense/mixer/wi", 1, 2048, 10944),
             ("unembed/w", 1, 2048, 102400)]
    stretch = {"waves": 2, "prompts": [1536],
               "decode_positions": [1600] * 128}
    least = 0.0
    for name, layers, k, n in packs:
        rows = [64, 64] + ([1] if name == "unembed/w" else [1536])
        least += sum(counts.least_seconds(counts.placed_call(r, k, n, 4),
                                          H100) for r in rows)
    # placed kernels took 3x their least time in all
    tr = Trace(kernels=[("dp4a_kernel<4, false>", 0.0, 3 * least)],
               spans=[("stretch", 0.0, 1.0)], stretch=(0.0, 1.0))
    run = {"stretch": stretch, "trace": tr, "peaks": H100, "batch": 64,
           "packs": packs, "config": cfg}
    share = spec.load_metric("placed_gemm_roofline").read(run)
    assert share == pytest.approx(100 / 3)
    mfu = spec.load_metric("model.step_mfu").read(run)
    flops = counts.model_flops(cfg, [1536], [1600] * 128)
    assert mfu == pytest.approx(100 * flops / H100["bf16_flops"])
    assert 0 < mfu <= 100
    # nothing to read: no trace, or no placed kernel in it
    assert spec.load_metric("placed_gemm_roofline").read(
        dict(run, trace=None)) is None
    tr2 = Trace(kernels=[("elementwise", 0.0, 0.5)],
                spans=[("stretch", 0.0, 1.0)], stretch=(0.0, 1.0))
    assert spec.load_metric("placed_gemm_roofline").read(
        dict(run, trace=tr2)) is None
