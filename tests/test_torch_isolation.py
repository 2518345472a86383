"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_sources_exist():
    files = _sources()
    assert len(files) > 20 and all(f.exists() for f in files)


#: The modules of the Table-I slice and the SiMRA sensing kernel, then of
#: partial recalibration, the noise fit, the pack archive, fault injection
#: and the paper's benchmarks, then of the drift-reliability loop and the
#: paper's remaining figures, then of the autotuner, the contract checker,
#: the session surface and the kernel benchmarks, then of MLA, MoE and the
#: serving-engine benchmark, then of the serving mesh and the API surface,
#: then of training on one device, then of sharding, then of the dry run
#: and the roofline: each is among the scanned sources (its CUDA source
#: among the built ones).
SLICE_MODULES = ("kernels/sense.py", "kernels/ops.py", "pud/device.py",
                 "pud/bitserial.py", "core/calibrate.py", "core/fleet.py",
                 "core/ecr.py", "core/throughput.py", "runtime/session.py",
                 "core/fit.py", "runtime/calib_cache.py", "pud/physics.py",
                 "pud/packed.py", "pud/placement.py", "pud/packer.py",
                 "pud/gemv.py", "kernels/ref.py", "benchmarks/__init__.py",
                 "benchmarks/common.py", "benchmarks/table1.py",
                 "benchmarks/fleet_calibration.py", "core/canary.py",
                 "core/reliability.py", "runtime/drift.py",
                 "launch/serve.py", "benchmarks/run.py",
                 "benchmarks/fig3_offsets.py",
                 "benchmarks/fig5_frac_sensitivity.py",
                 "benchmarks/fig6_reliability.py",
                 "benchmarks/calibration_convergence.py",
                 "benchmarks/majx_general.py", "benchmarks/placement.py",
                 "benchmarks/drift_recovery.py", "analysis/__init__.py",
                 "analysis/__main__.py", "analysis/errors.py",
                 "analysis/contracts.py", "kernels/autotune.py",
                 "kernels/backends.py", "kernels/placed_gemm.py",
                 "kernels/plane_gemm.py", "runtime/tune.py",
                 "benchmarks/mvdram_serving.py", "benchmarks/kernel_bench.py",
                 "benchmarks/kernel_microbench.py", "models/attention.py",
                 "models/moe.py", "models/transformer.py",
                 "configs/archs.py", "benchmarks/serving_engine.py",
                 "launch/mesh.py", "api.py", "models/ssm.py",
                 "models/ssm_lm.py", "models/hybrid.py", "models/encdec.py",
                 "models/multimodal.py", "models/layers.py",
                 "runtime/steps.py", "runtime/engine.py",
                 "runtime/optim.py", "runtime/data.py",
                 "runtime/checkpoint.py", "launch/train.py",
                 "models/params.py", "configs/registry.py",
                 "runtime/sharding.py", "models/sharding_ctx.py",
                 "runtime/pipeline.py", "launch/dryrun.py",
                 "launch/cost_analysis.py", "benchmarks/roofline.py")


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_scanned(module):
    assert ROOT / "src" / "repro_torch" / module in _sources()


def test_every_cuda_source_is_built():
    from repro_torch.kernels import build
    on_disk = sorted(p.stem for p in
                     (ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))
    assert on_disk == sorted(build.SOURCES)
    assert "simra_sense" in build.SOURCES


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    prog = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print('LOADED', len(sys.modules), 'BAD', bad)\n")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, cwd=ROOT, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout


def test_port_module_names_stay_clear_of_the_reference_kernels():
    """The reference's lint keeps its kernel modules private by name
    (``majx``, ``bitplane_gemv``, ``bitplane_gemm``): no port module takes
    one of those names."""
    names = {p.stem for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert not names & {"majx", "bitplane_gemv", "bitplane_gemm"}


def test_no_raw_pack_dicts_in_the_port():
    """The reference's lint (``no-raw-pack-dicts``) over the port: no dict
    literal with both ``"planes"`` and ``"scale"`` keys."""
    from repro.analysis.lint import lint_paths
    findings = [f for f in lint_paths([ROOT / "src" / "repro_torch"])
                if f.rule in ("no-raw-pack-dicts", "no-direct-kernel-imports")]
    assert findings == []
