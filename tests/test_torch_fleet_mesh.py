"""The port's serving mesh, the mesh path of ``calibrate_fleet``,
``serve --mesh`` and ``repro_torch.api`` against the JAX package.

  * ``parse_mesh_spec`` raises the reference's errors; positions map to
    cards as ``(d * M + m) % cards`` (a stand-in device count on the CPU);
  * ``calibrate_fleet`` split over 2 and 4 positions equals the
    single-device run bit for bit (levels and bias history; the split
    changes where each block runs, not what it draws);
  * ``serve --mesh 2,2 --pud-gemv --engine --device cpu`` serves, and its
    flag errors are the reference's;
  * ``repro_torch.api.__all__`` is the reference's, and every name
    resolves in the port.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.serve import main as j_main  # noqa: E402
import repro.api as japi  # noqa: E402
from repro_torch.core.calibrate import CalibrationConfig  # noqa: E402
from repro_torch.core.fleet import (FleetConfig, calibrate_fleet,  # noqa: E402
                                    manufacture_fleet)
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.serve import main, parse_args  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402


@pytest.mark.parametrize("spec", ["2x2", "a,b", "2", "1,2,3", "0,2",
                                  "2,-1"])
def test_parse_mesh_spec_errors_match_reference(spec):
    with pytest.raises(ValueError) as port:
        mesh.parse_mesh_spec(spec, device="cpu")
    with pytest.raises(ValueError) as ref:
        jmesh.parse_mesh_spec(spec)
    assert str(port.value) == str(ref.value)


def test_positions_map_round_the_cards(monkeypatch):
    m = mesh.parse_mesh_spec("2,2", device="cpu")
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.describe() == "(0,0)->cpu, (0,1)->cpu, (1,0)->cpu, (1,1)->cpu"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = mesh.make_host_mesh(2, 2, device="cuda")
    assert [[d.index for d in row] for row in cards.devices] == [[0, 1],
                                                                 [2, 0]]
    one = mesh.make_mesh_for_devices(device="cuda")
    assert one.shape == {"data": 3, "model": 1}
    given = mesh.make_host_mesh(1, 2, devices=[["cpu", "cpu"]])
    assert given.devices == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError, match="not a 2x2 grid"):
        mesh.make_host_mesh(2, 2, devices=[["cpu", "cpu"]])


@pytest.mark.parametrize("method", ["fused", "reference"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["2dev", "4dev"])
def test_calibrate_fleet_mesh_equals_single_device(shape, method):
    p = PhysicsParams()
    cfg = FleetConfig(n_channels=1, n_banks=2, n_subarrays=4, n_cols=256)
    cal = CalibrationConfig(n_iterations=3, n_samples=64)
    offs = manufacture_fleet(1, cfg, p, device="cpu")
    single = calibrate_fleet(1, offs, cfg, p, cal, method=method)
    split = calibrate_fleet(1, offs, cfg, p, cal, method=method,
                            mesh=mesh.make_host_mesh(*shape, device="cpu"))
    assert split.levels.shape == (8, 256)
    assert torch.equal(split.levels, single.levels)
    assert torch.equal(split.mean_abs_bias, single.mean_abs_bias)
    assert float(split.mean_abs_bias[-1]) < float(split.mean_abs_bias[0])


def test_calibrate_fleet_mesh_must_divide_the_grid():
    p = PhysicsParams()
    cfg = FleetConfig(n_channels=1, n_banks=1, n_subarrays=6, n_cols=64)
    offs = manufacture_fleet(1, cfg, p, device="cpu")
    with pytest.raises(ValueError,
                       match="6 subarrays not divisible over 4 devices"):
        calibrate_fleet(1, offs, cfg, p, mesh=mesh.make_host_mesh(
            2, 2, device="cpu"))


def test_serve_mesh_on_cpu(tmp_path, capsys):
    argv = ["--preset", "smoke", "--batch", "4", "--prompt-len", "8",
            "--gen", "2", "--pud-gemv", "--engine", "--mesh", "2,2",
            "--batch-size", "2", "--calib-cache", str(tmp_path),
            "--fleet-subarrays", "2", "--fleet-cols", "512",
            "--device", "cpu"]
    assert main(argv) == 0
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "fleet mesh 2x2 (data x model), 4 logical devices" in out
    assert "(1,1)->cpu" in out
    assert "(0 cache hits)" in out and "(4 cache hits)" in out
    assert "fleet engine: 4 requests over 2 lanes" in out
    assert "2 slots/lane" in out and "token agreement vs bf16" in out
    assert "aggregate DDR4-PUD model" in out
    assert "[['planned', 'planned'], ['planned', 'planned']]" in out
    assert "[['hit', 'hit'], ['hit', 'hit']]" in out


@pytest.mark.parametrize("argv", [
    ["--mesh", "2,2"],
    ["--mesh", "2,2", "--pud-gemv"],
    ["--mesh", "2,2", "--engine"],
    ["--mesh", "2,2", "--pud-gemv", "--engine", "--monitor"]])
def test_serve_mesh_flag_errors_match_reference(argv, capsys):
    with pytest.raises(SystemExit) as port:
        parse_args(argv)
    port_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as ref:
        j_main(argv)
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert port.value.code == ref.value.code == 2
    assert port_err.split(": error: ")[1] == ref_err.split(": error: ")[1]


def test_api_all_matches_reference():
    """The same names; each callable bound to the port's own, each
    constant equal to the reference's."""
    from repro_torch import api
    assert api.__all__ == japi.__all__
    for name in api.__all__:
        obj, ref = getattr(api, name), getattr(japi, name)
        if callable(ref):
            assert callable(obj), name
            assert obj.__module__.startswith("repro_torch."), name
        else:
            assert obj == ref, name
