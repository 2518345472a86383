"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` into a shared library with a plain
C interface, all sources at once in parallel, for ``sm_90a``.  Libraries go
under ``src/repro_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so a checkout builds once and reuses the result.  ``ctypes`` loads
them; every pointer and the stream pass as ``c_void_p``.

Nothing here runs at import time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[1] / "_build"

#: Hopper target.  ``-fmad=false`` keeps every float multiply and add
#: separately rounded (the calibration kernel's threshold tests must match
#: the plain version bit for bit); division and sqrt stay IEEE-rounded
#: because ``--use_fast_math`` is not given.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC", "-lineinfo")

SOURCES = ("calib_iter", "placed_gemm", "plane_gemm", "simra_sense")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source that has no library yet, in parallel.

    Returns {name: library path}.  ``nvcc``'s ptxas report (registers,
    shared memory, spills per kernel) is kept in ``<name>.log`` beside the
    library.  Raises with the compiler output if any build fails.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {n: out_dir / f"lib{n}.so" for n in SOURCES}
    todo = [n for n in SOURCES if not libs[n].exists()]
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.so.tmp-{os.getpid()}"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _LIBS[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report of one source."""
    path = build_dir() / f"{name}.log"
    return path.read_text() if path.exists() else ""
