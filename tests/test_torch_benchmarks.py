"""The port's paper benchmarks (``repro_torch.benchmarks``) at small scales
on the CPU: each prints a ``#csv`` block whose columns are the reference
benchmark's (read from the reference's source), and its checks pass (the
fused-vs-plain parity leg bit for bit).  Fig. 3 is deterministic and held
to the reference's rows field for field; ``placement`` and
``drift_recovery`` run at their own smoke configurations; the ``run``
harness lists, selects and fails as the reference's does.  The figures'
numbers beside the reference's runs are in ``test_torch_figures.py``.
The kernel benchmarks run their plain versions here: their rows, the
traffic gate, the baseline gate and the harness entries; the MVDRAM
serving rows are held to the reference's in
``test_torch_session_surface.py``."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro_torch.benchmarks import (common, drift_recovery,  # noqa: E402
                                    fig3_offsets, fig6_reliability,
                                    fleet_calibration, placement, run,
                                    table1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_columns(module: str, first_key: str) -> list[str]:
    """Keys of the first dict literal in ``benchmarks/<module>.py`` whose
    first key is ``first_key`` (the row the benchmark emits)."""
    tree = ast.parse((ROOT / "benchmarks" / f"{module}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Dict) and node.keys
                and isinstance(node.keys[0], ast.Constant)
                and node.keys[0].value == first_key):
            return [k.value for k in node.keys]
    raise AssertionError(f"no emitted row in benchmarks/{module}.py")


def _csv_block(text: str, name: str) -> list[list[str]]:
    lines = text.splitlines()
    start = lines.index(f"#csv {name}")
    rows = []
    for line in lines[start + 1:]:
        if not line.strip():
            break
        if not line.startswith("#"):
            rows.append(line.split(","))
    return rows


@pytest.fixture(autouse=True)
def _artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "ART", tmp_path)


def test_table1_prints_the_reference_columns(capsys, tmp_path):
    assert table1.main(["--n-cols", "256", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = _csv_block(out, "table1")
    assert rows[0] == _reference_columns("table1", "method")
    assert [r[0] for r in rows[1:]] == ["B300", "T210",
                                        "gain_T210_over_B300"]
    assert all(len(r) == len(rows[0]) for r in rows)
    assert float(rows[2][1]) < float(rows[1][1])      # T210 ECR < B300's
    assert "Table I validation vs paper:" in out and "stages:" in out
    assert (tmp_path / "table1.json").exists()


def test_table1_run_at_a_given_scale():
    from repro_torch.core.calibrate import CalibrationConfig
    rows = table1.run(common.BenchScale(n_cols=256, n_trials_maj5=64,
                                        n_cols_arith=32, n_trials_arith=64),
                      seed=3, device="cpu",
                      calib_config=CalibrationConfig(n_iterations=6,
                                                     n_samples=64))
    assert [r["method"] for r in rows] == ["B300", "T210",
                                           "gain_T210_over_B300"]
    assert list(rows[0]) == _reference_columns("table1", "method")


def test_fleet_calibration_prints_the_reference_columns(capsys, tmp_path):
    assert fleet_calibration.main(
        ["--subarrays", "4", "--n-cols", "256", "--n-trials", "256",
         "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    rows = _csv_block(out, "fleet_calibration")
    assert rows[0] == _reference_columns("fleet_calibration", "subarrays")
    assert len(rows) == 2 and len(rows[1]) == len(rows[0])
    assert rows[1][rows[0].index("method")] == "fused"
    assert "fused kernel parity (16x512, 4 iters): bit-exact" in out
    assert "cached-table startup: HIT" in out
    assert (tmp_path / "fleet_calibration.json").exists()


@pytest.mark.parametrize("method,other", [("fused", "reference"),
                                          ("reference", "fused")])
def test_fleet_calibration_check_full_holds_the_main_leg(capsys, method,
                                                         other):
    assert fleet_calibration.main(
        ["--subarrays", "4", "--n-cols", "128", "--n-trials", "64",
         "--method", method, "--check-full", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert (f"main leg == {other} on the same inputs, bit for bit: "
            f"calib_iter at [4, 512, 5, 128] x 20 iters") in out


def test_fleet_calibration_check_full_fails_on_a_differing_main_leg(
        monkeypatch):
    real = fleet_calibration.calibrate_fleet

    def off_by_one(*args, method, **kw):
        cal = real(*args, method=method, **kw)
        if method == "fused":
            cal.levels[0, 0] += 1
        return cal

    monkeypatch.setattr(fleet_calibration, "calibrate_fleet", off_by_one)
    with pytest.raises(RuntimeError, match=r"main leg \(fused\) differs "
                       "from reference"):
        fleet_calibration.main(["--subarrays", "4", "--n-cols", "128",
                                "--n-trials", "64", "--check-full",
                                "--device", "cpu"])


def test_parse_scale_matches_the_reference_flags():
    scale, device = common.parse_scale(["--full", "--device", "cpu"])
    assert (scale.n_cols, scale.n_cols_arith, scale.full) == (65536, 4096,
                                                              True)
    assert device == "cpu"
    scale, device = common.parse_scale(["--n-cols", "512"])
    assert scale.n_cols == 512 and device is None


def test_benchmarks_need_a_device_without_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_calibration.main(["--subarrays", "4", "--n-cols", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table1.main(["--n-cols", "64"])


# ---------------------------------------------------------------------------
# The paper's figures (their rows beside the reference's runs are in
# test_torch_figures.py; every report runs in the chip script's CPU
# rehearsal, test_torch_serve.py)
# ---------------------------------------------------------------------------

TINY = common.BenchScale(n_cols=128, n_trials_maj5=64)


def test_fig3_rows_equal_reference(capsys):
    from benchmarks import fig3_offsets as ref
    assert fig3_offsets.run() == ref.run()
    assert fig3_offsets.main([]) == 0
    out = capsys.readouterr().out
    rows = _csv_block(out, "fig3_offsets")
    assert rows[0] == list(ref.run()[0])
    by = {r[0]: r for r in rows[1:]}
    assert by["T210"][1:4] == ["8", "1.59353", "0.17509"]
    assert by["T000"][1:4] == ["4", "3", "1"]
    assert "Fig. 3 structure checks:" in out


def test_fig6_report_prints_both_blocks(capsys):
    fig6_reliability.report(TINY, "cpu")
    out = capsys.readouterr().out
    assert _csv_block(out, "fig6_temperature")[0] == ["temp_c", "ecr_pct",
                                                      "new_ecr_pct"]
    assert _csv_block(out, "fig6_time")[0] == ["days", "ecr_pct",
                                               "new_ecr_pct"]
    assert "(paper < 0.14%)" in out and "(paper < 0.27%)" in out


def test_placement_at_its_smoke_config(capsys):
    placement.report(device="cpu")
    out = capsys.readouterr().out
    rows = _csv_block(out, "placement")
    assert rows[0] == _reference_columns("placement", "arch")
    row = dict(zip(rows[0], rows[1]))
    assert row["arch"] == "qwen3-1.7b" and row["subarrays"] == "8"
    assert 0 < float(row["occupancy"]) <= 1
    assert 0 < float(row["unplaced_faulty_frac"]) < 0.2
    # the demand is the reference's: the same smoke model's requests
    import jax
    from repro.configs import get as j_get
    from repro.models.params import init_params as j_init
    from repro.pud.gemv import (ATTN_PACKABLE, FFN_PACKABLE,
                                PUDGemvConfig as JCfg)
    from repro.pud.packer import packing_requests as j_reqs
    jm = j_get("qwen3-1.7b").make_smoke()
    reqs = j_reqs(j_init(jm.param_defs(), jax.random.key(0)),
                  JCfg(packable=FFN_PACKABLE + ATTN_PACKABLE))
    assert int(row["demand_cols"]) == sum(r.total_cols for r in reqs)


def test_drift_recovery_at_its_smoke_config(capsys, tmp_path):
    import json
    drift_recovery.report(device="cpu")
    out = capsys.readouterr().out
    rows = _csv_block(out, "drift_recovery")
    assert rows[0] == _reference_columns("drift_recovery", "drift_step")
    assert "post-swap decode bit-identical to fresh pack: OK" in out
    row = json.loads((tmp_path / "drift_recovery.json").read_text())[0]
    row["ecr_before"] = {int(g): e for g, e in row["ecr_before"].items()}
    row["ecr_after"] = {int(g): e for g, e in row["ecr_after"].items()}
    assert row["drift_subarrays"] == [1, 5]
    assert row["detection_latency_steps"] >= 0
    assert all(row["ecr_after"][g] > row["ecr_before"][g] for g in (1, 5))


def test_drift_recovery_fails_without_a_recovery(monkeypatch):
    # at the nominal temperature nothing drifts, so nothing recovers
    monkeypatch.setattr(drift_recovery, "DRIFT_TEMP_C", 50.0)
    with pytest.raises(AssertionError, match="no recovery happened"):
        drift_recovery.run(device="cpu")


@pytest.mark.parametrize("name", ["drift_recovery", "placement"])
def test_check_plain_holds_the_kernel_launches(capsys, name):
    mod = {"drift_recovery": drift_recovery, "placement": placement}[name]
    mod.report(common.BenchScale(check_plain=True), "cpu")
    out = capsys.readouterr().out
    assert (f"{name}: kernels == plain versions on the same inputs, bit "
            "for bit") in out
    assert f"#csv {name}" in out


def test_check_plain_fails_on_a_differing_kernel_leg(monkeypatch):
    real = placement._run

    def off_by_one(device, plain):
        rows, computed = real(device, plain)
        if not plain:
            computed["levels"][0, 0] += 1
        return rows, computed

    monkeypatch.setattr(placement, "_run", off_by_one)
    with pytest.raises(RuntimeError, match="placement: the kernels' run "
                       "differs from the plain versions'"):
        placement.report(common.BenchScale(check_plain=True), "cpu")


def test_hold_to_plain_compares_bit_for_bit():
    import torch
    t = torch.arange(4, dtype=torch.int32)
    row = {"a": 1, "b": [0.5, {"c": t}]}
    common.hold_to_plain("x", (row, [t]), ({"a": 1, "b": [0.5, {"c": t}]},
                                           [t.clone()]))
    for other in ({"a": 1, "b": [0.5, {"c": t + 1}]},
                  {"a": 1, "b": [0.5, {"c": t.to(torch.int64)}]},
                  {"a": 1, "b": [0.25, {"c": t}]},
                  {"a": 1, "b": (0.5, {"c": t})},
                  {"a": 1}):
        with pytest.raises(RuntimeError, match="x: the kernels' run"):
            common.hold_to_plain("x", row, other)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------

def test_run_lists_only_what_the_port_has(capsys):
    assert run.main(["--list"]) == 0
    names = [line.split()[0] for line in
             capsys.readouterr().out.splitlines() if line and
             not line.startswith(" ")]
    assert names == ["fig3", "table1", "fig5", "fig6", "convergence",
                     "fleet", "kernels", "kernel_microbench", "serving",
                     "serving_engine", "drift", "majx", "placement",
                     "roofline"]
    from benchmarks.run import BENCHES as REF
    assert [n for n in REF if n in names] == names


def test_run_only_one(capsys, tmp_path, monkeypatch):
    assert run.main(["--only", "fig3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "#csv fig3_offsets" in out
    assert "1 benchmark(s) in" in out and "all passed" in out
    from repro_torch.benchmarks import roofline
    monkeypatch.setattr(roofline, "ART", tmp_path)   # no dry-run records
    assert run.main(["--only", "roofline"]) == 0
    out = capsys.readouterr().out
    for mesh in ("single", "multi"):
        assert (f"-- mesh: {mesh}: no dry-run artifacts under "
                f"{tmp_path / mesh}") in out
    assert "python -m repro_torch.launch.dryrun first" in out
    assert "1 benchmark(s) in" in out and "all passed" in out


def test_a_raising_benchmark_fails_the_run_and_the_rest_still_run(
        capsys, monkeypatch):
    seen = []

    def boom(scale, device):
        raise AssertionError("boom")

    monkeypatch.setattr(run, "BENCHES", {
        "fig3": run.BENCHES["fig3"], "boom": boom,
        "after": lambda scale, device: seen.append(device)})
    assert run.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "#csv fig3_offsets" in out and seen == ["cpu"]
    assert "benchmark 'boom' FAILED" in out
    assert "3 benchmark(s) in" in out and "1 FAILED (boom)" in out


def test_run_benches_reports_walls():
    walls = run.run_benches(["fig3"], common.BenchScale(), "cpu")
    assert list(walls) == ["fig3"] and walls["fig3"][1] is False


# ---------------------------------------------------------------------------
# The kernel benchmarks (kernel_bench, kernel_microbench) on the CPU
# ---------------------------------------------------------------------------


def test_kernel_bench_rows_and_modeled_columns(capsys):
    from repro_torch.benchmarks import kernel_bench
    rows = kernel_bench.report(device="cpu")
    text = capsys.readouterr().out
    assert [(r["kernel"], r["mode"]) for r in rows] == [
        ("majx_sense", "plain (cpu)"), ("majx_sense", "plain"),
        ("bitplane_gemm", "planes"), ("bitplane_gemm", "folded"),
        ("bitplane_gemm", "plain")]
    assert {r["shape"] for r in rows} == {"16x8x4096", "8x2048x2048@4b"}
    gemm = rows[2]
    assert gemm["ops"] == 2 * 8 * 2048 * 2048
    assert gemm["bytes"] == 4 * 2048 * 2048 + 8 * 2048 + 8 * 2048 * 4
    assert rows[0]["bytes"] == (16 * 8 * 4096 + 2 * 16 * 4096 + 4096) * 4
    assert all(r["device"] == "cpu" and r["ms"] > 0 and r["equal_to_plain"]
               for r in rows)
    assert "#csv kernel_bench" in text
    assert "kernel_bench: kernels == plain versions on the same inputs" \
        in text


def test_kernel_microbench_on_the_cpu(capsys, tmp_path):
    """16 rows (four entries x two formats x two modes), the measured
    traffic reduction gate, no tuning on the CPU, and the payload under
    the artifacts directory, never the reference's BENCH_kernels.json."""
    from repro_torch.benchmarks import kernel_microbench as mb
    ref_bench = (ROOT / "BENCH_kernels.json").read_bytes()
    assert mb.main(["--device", "cpu", "--reps", "1"]) == 0
    text = capsys.readouterr().out
    payload = __import__("json").loads((tmp_path / mb.PAYLOAD).read_text())
    rows = payload["rows"]
    assert len(rows) == 16 and payload["device"]["name"] == "cpu"
    assert {(r["kernel"], r["layout"], r["format"], r["mode"])
            for r in rows} == {(k, lo, f, m) for k in ("gemv", "gemm")
                               for lo in ("logical", "placed")
                               for f in ("dense", "bitpacked")
                               for m in ("planes", "folded")}
    assert all(r["tuned_plan"] is None and r["tuned_speedup"] is None
               for r in rows)
    for name, red in payload["traffic_reduction"].items():
        assert red >= mb.MIN_REDUCTION, name
    assert "tuning needs the GPU" in text and "#csv kernel_microbench" in text
    assert "kernel_microbench: kernels == plain versions" in text
    assert (ROOT / "BENCH_kernels.json").read_bytes() == ref_bench
    assert str(mb.DEFAULT_TUNING_DIR).endswith(".pud-tuning-torch")
    # the baseline gate against a file the caller gives
    base = tmp_path / "base.json"
    base.write_text(__import__("json").dumps(payload))
    assert mb.main(["--device", "cpu", "--reps", "1", "--compare",
                    str(base), "--tolerance", "10"]) == 0
    assert "compare: OK" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        mb.main(["--device", "cpu", "--tune-only"])


def test_kernel_microbench_compare_rows():
    from repro_torch.benchmarks.kernel_microbench import compare_rows

    def row(kernel, tps):
        return dict(kernel=kernel, layout="logical", format="dense",
                    mode="folded", batch=1, tokens_per_second=tps)

    base = [row("gemv", 100.0), row("gemm", 800.0)]
    # twice as fast everywhere: no regression after normalization
    assert compare_rows([row("gemv", 200.0), row("gemm", 1600.0)],
                        base)[0] == []
    fails, rep = compare_rows([row("gemv", 50.0), row("gemm", 800.0)],
                              base)
    assert len(fails) == 1 and "gemv" in fails[0]
    assert compare_rows([row("gemv", 50.0), row("gemm", 800.0)], base,
                        absolute=True)[0][0].startswith("gemv")
    fails, _ = compare_rows([row("gemv", 100.0)], base)
    assert fails == ["baseline row gemm/logical/dense/folded/b1 missing "
                     "from this run"]
    assert compare_rows([], base)[0][-1] == "no rows shared with the baseline"


def test_harness_runs_the_serving_table(capsys):
    """``--only serving`` through the harness (``kernels`` and
    ``kernel_microbench`` run through it in the chip script's rehearsal,
    ``test_torch_serve.py``)."""
    assert run.main(["--only", "serving", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "#csv mvdram_serving" in out and "all passed" in out


# ---------------------------------------------------------------------------
# The serving-engine benchmark (serving_engine) on the CPU
# ---------------------------------------------------------------------------

TRACE_KEYS = ("requests", "p50_e2e_ms", "p99_e2e_ms", "p50_tok_ms",
              "p99_tok_ms", "hit_rate", "mode", "score")


@pytest.fixture(scope="module")
def trace_rows():
    import torch
    from repro_torch.benchmarks import serving_engine as se
    from repro_torch.configs import get
    from repro_torch.models.params import init_params
    model = get(se.ARCH).make_smoke()
    with torch.inference_mode():
        return se.run_trace(model, init_params(model.param_defs(), 0, "cpu"))


def test_serving_trace_rows_equal_reference_bench_serving(trace_rows):
    """The modeled-clock latencies depend on the scheduler alone: every
    field of both modes equals the reference's committed rows."""
    import json
    want = json.loads((ROOT / "BENCH_serving.json").read_text())["rows"]
    assert [list(r) for r in trace_rows] == [list(TRACE_KEYS)] * 2
    assert trace_rows == want
    by = {r["mode"]: r for r in trace_rows}
    assert by["chunked_cached"]["p99_e2e_ms"] < by["baseline"]["p99_e2e_ms"]
    assert by["chunked_cached"]["hit_rate"] > 0


def test_serving_trace_compare_fails_on_doctored_baseline(trace_rows):
    import copy
    from repro_torch.benchmarks.serving_engine import compare_trace_rows
    assert compare_trace_rows(trace_rows, trace_rows) == []
    # a uniformly faster baseline cancels in the geomean normalisation
    faster = copy.deepcopy(trace_rows)
    for r in faster:
        r["score"] *= 3
    assert compare_trace_rows(trace_rows, faster) == []
    doctored = copy.deepcopy(trace_rows)
    doctored[1]["score"] *= 2          # chunked_cached twice as good
    fails = compare_trace_rows(trace_rows, doctored)
    assert len(fails) == 1 and fails[0].startswith("chunked_cached")
    assert compare_trace_rows(trace_rows[:1], trace_rows) == [
        "baseline mode chunked_cached missing from this run"]


def test_serving_engine_main_gates_and_leaves_bench_serving(
        capsys, tmp_path, monkeypatch, trace_rows):
    """``main`` on the CPU: the batch sweep (monotone model rate up to the
    optimum), the shard rows, the trace gated against the reference's
    ``BENCH_serving.json`` (OK), the payload under the artifacts directory
    and ``BENCH_serving.json`` byte-identical; a doctored baseline exits
    non-zero."""
    import json
    from repro_torch.benchmarks import serving_engine as se
    ref = (ROOT / "BENCH_serving.json").read_bytes()
    # the trace replay is the module fixture's (the same ``run_trace``)
    monkeypatch.setattr(se, "run_trace", lambda model, params: trace_rows)
    assert se.main(["--device", "cpu", "--compare",
                    str(ROOT / "BENCH_serving.json")]) == 0
    text = capsys.readouterr().out
    assert "#csv serving_engine" in text and "#csv serving_trace" in text
    assert "monotone up to the optimum: OK" in text
    assert "compare: OK" in text and "(acceptance floor 2.0x): OK" in text
    payload = json.loads((tmp_path / se.PAYLOAD).read_text())
    assert payload["rows"] == trace_rows and payload["device"] == "cpu"
    assert (ROOT / "BENCH_serving.json").read_bytes() == ref
    sweep = json.loads((tmp_path / "serving_engine.json").read_text())
    assert [r["batch_size"] for r in sweep][:3] == [1, 2, 4]
    assert sum(r["is_optimum"] for r in sweep) == 1
    shards = json.loads((tmp_path / "serving_engine_sharded.json"
                         ).read_text())
    assert [r["n_shards"] for r in shards] == [1, 2, 4]
    doctored = json.loads(ref)
    doctored["rows"][1]["score"] *= 2
    bad = tmp_path / "doctored.json"
    bad.write_text(json.dumps(doctored))
    monkeypatch.setattr(se, "run", lambda device=None: (sweep, shards))
    with pytest.raises(SystemExit, match="regressed"):
        se.main(["--device", "cpu", "--compare", str(bad)])
    assert "REGRESSION chunked_cached" in capsys.readouterr().out


def test_mvdram_serving_rows_of_the_moe_archs():
    from repro_torch.benchmarks import mvdram_serving
    rows = {r["arch"]: r for r in mvdram_serving.run(device="cpu")}
    assert rows["deepseek-v2-lite-16b"]["active_params_B"] == 2.7
    assert rows["llama4-scout-17b-a16e"]["active_params_B"] == 17.0
    assert rows["deepseek-v2-lite-16b"]["pudtune_tok_s"] > \
        rows["llama4-scout-17b-a16e"]["pudtune_tok_s"]
