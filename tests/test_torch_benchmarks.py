"""The port's paper benchmarks (``repro_torch.benchmarks.table1`` and
``fleet_calibration``) at their smallest scale on the CPU: each prints a
``#csv`` block whose columns are the reference benchmark's (read from the
reference's source, which would take a minute to run here), and its
checks pass (the fused-vs-plain parity leg bit for bit)."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

from repro_torch.benchmarks import common, fleet_calibration, table1  # noqa: E402

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
