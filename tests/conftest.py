"""Shared pytest config.

NOTE: deliberately does NOT set XLA_FLAGS / device counts — smoke tests must
see the single real CPU device; only launch/dryrun.py forces 512 host devices.
Multi-device tests go through the :func:`forced_devices` fixture below, which
runs their program text in a subprocess with the flag in its environment.
Enables the persistent compilation cache so the big unrolled MAJ-graph
compiles (MUL8 ~ 250 MAJX ops) are paid once per machine, not per run.

Crash-loop guard: a process killed mid-compile can leave a torn cache entry,
and XLA's native deserializer segfaults on it — every later run then dies at
the same test.  A sentinel marks the suite as running; if it is still there
at startup, the previous run died hard and the cache is purged (one-time
recompile instead of a persistent crash loop).
"""
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import jax
import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_forced_devices(prog: str, *, marker: str, devices: int = 4,
                       timeout: int = 600) -> subprocess.CompletedProcess:
    """Run ``prog`` in a fresh interpreter with ``devices`` forced host CPUs.

    XLA only honors ``--xla_force_host_platform_device_count`` if it is set
    before jax initializes, and this process's jax is already live on the
    single real CPU device — so multi-device tests ship their program text
    to a subprocess with the flag in its environment.  Asserts that
    ``marker`` (the program's success print) appears on stdout and returns
    the completed process for extra assertions.
    """
    env = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"),
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(prog)],
                       capture_output=True, text=True, env=env,
                       cwd=str(REPO_ROOT), timeout=timeout)
    assert marker in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return r


@pytest.fixture
def forced_devices():
    """The :func:`run_forced_devices` subprocess runner, as a fixture."""
    return run_forced_devices

_CACHE = pathlib.Path(os.environ.get("JAX_COMPILATION_CACHE_DIR",
                                     "/tmp/jax_compilation_cache"))

jax.config.update("jax_compilation_cache_dir", str(_CACHE))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def _sentinel() -> pathlib.Path:
    return _CACHE / f".suite-running-{os.getpid()}"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # e.g. EPERM: exists but not ours
    return True


def pytest_sessionstart(session):
    # One sentinel per session (pid-stamped): a sentinel whose process is
    # gone means that run died hard, possibly mid-compile — purge.  A live
    # pid is a concurrent session, not a crash; leave its cache alone.
    stale = [p for p in _CACHE.glob(".suite-running-*")
             if not _pid_alive(int(p.name.rsplit("-", 1)[-1]))]
    if stale:
        shutil.rmtree(_CACHE, ignore_errors=True)
    _CACHE.mkdir(parents=True, exist_ok=True)
    _sentinel().write_text("")


def pytest_sessionfinish(session, exitstatus):
    try:
        _sentinel().unlink()
    except OSError:
        pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
