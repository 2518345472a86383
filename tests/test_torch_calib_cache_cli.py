"""Parity of the port's calibration-cache inspection (``entries``,
``evict``, ``CalibrationTable.age_days`` and the ``--list`` / ``--stats`` /
``--evict`` CLI) with the JAX package's, on one cache root the reference
wrote.  Printed lines are compared exactly, with the age field masked
(the two runs read the clock at different times)."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.core.fleet import FleetConfig as JFleet  # noqa: E402
from repro.pud import placement as jpl  # noqa: E402
from repro.pud.physics import PhysicsParams as JPhys  # noqa: E402
from repro.runtime import calib_cache as jcc  # noqa: E402
from repro_torch.core.fleet import FleetConfig  # noqa: E402
from repro_torch.pud.physics import PhysicsParams  # noqa: E402
from repro_torch.runtime import calib_cache as cc  # noqa: E402

GRIDS = [dict(n_channels=1, n_banks=2, n_subarrays=2, n_cols=256),
         dict(n_channels=1, n_banks=1, n_subarrays=3, n_cols=512)]


def _root(tmp_path):
    """Three table entries of two devices (one with two placements, one
    without age metadata), a crashed save and a torn manifest."""
    root = tmp_path / "cache"
    cache = jcc.CalibrationTableCache(root)
    rng = np.random.default_rng(0)
    for i, (dev, grid) in enumerate([("dimm0", GRIDS[0]),
                                     ("dimm0", GRIDS[1]),
                                     ("dimm1", GRIDS[0])]):
        cfg = JFleet(**grid)
        g, c = cfg.n_subarrays_total, cfg.n_cols
        masks = rng.random((g, c)) < 0.1
        cache.save(dev, cfg, JPhys(), rng.integers(0, 8, (g, c)),
                   ecr=masks.mean(1), masks=masks,
                   metadata={"method": "fused", "i": i},
                   calibrated_at=1.7e9 + 86400.0 * i)
        if i == 0:
            for name in ("a", "b"):
                plan = jpl.plan_placement(masks, [jpl.PlacementRequest(
                    "w", 64, 0)])
                cache.save_placement(dev, cfg, JPhys(), name, plan)
    entry = next((root / "dimm1").iterdir())
    manifest = entry / "manifest.json"
    manifest.write_text(manifest.read_text().replace(
        '"calibrated_at"', '"calibrated_at_old"'))
    (root / "dimm1" / (entry.name + ".tmp-99")).mkdir()
    torn = root / "dimm2" / "Tx__1x1x1x8__0"
    torn.mkdir(parents=True)
    (torn / "manifest.json").write_text("{not json")
    return root


def _cli(module, *args):
    r = subprocess.run([sys.executable, "-m", module, *args],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": "src"},
                       cwd=str(__import__("pathlib").Path(__file__)
                               .resolve().parents[1]))
    assert r.returncode == 0, r.stderr
    return re.sub(r"age \d+\.\dd", "age <masked>", r.stdout)


@pytest.mark.parametrize("flag", ["--list", "--stats"])
def test_list_and_stats_print_what_the_reference_prints(tmp_path, flag):
    root = _root(tmp_path)
    got = _cli("repro_torch.runtime.calib_cache", "--root", str(root), flag)
    want = _cli("repro.runtime.calib_cache", "--root", str(root), flag)
    assert got == want
    assert got.strip()
    if flag == "--list":
        assert got.count("age <masked>") == 2 and "age unknown" in got


def test_empty_root_prints_what_the_reference_prints(tmp_path):
    for flag in ("--list", "--stats"):
        args = ("--root", str(tmp_path / "none"), flag)
        assert _cli("repro_torch.runtime.calib_cache", *args) == \
            _cli("repro.runtime.calib_cache", *args)


def test_evict_removes_the_same_count(tmp_path, capsys):
    root = _root(tmp_path)
    twin = tmp_path / "twin"
    shutil.copytree(root, twin)
    for dev in ("dimm0", "dimm1", "nobody"):
        assert cc.main(["--root", str(root), "--evict", dev]) == 0
        got = capsys.readouterr().out
        assert jcc.main(["--root", str(twin), "--evict", dev]) == 0
        assert got == capsys.readouterr().out
    assert sorted(p.name for p in root.iterdir()) == \
        sorted(p.name for p in twin.iterdir()) == ["dimm2"]


def test_entries_and_evict_match_reference(tmp_path):
    root = _root(tmp_path)
    assert cc.CalibrationTableCache(root).entries() == \
        jcc.CalibrationTableCache(root).entries()
    assert len(cc.CalibrationTableCache(root).entries()) == 3
    assert cc.CalibrationTableCache(tmp_path / "none").entries() == []
    twin = tmp_path / "twin"
    shutil.copytree(root, twin)
    assert cc.CalibrationTableCache(root).evict("dimm0") == \
        jcc.CalibrationTableCache(twin).evict("dimm0") == 2
    assert cc.CalibrationTableCache(root).evict("dimm0") == 0


def test_age_days_matches_reference(tmp_path):
    root = _root(tmp_path)
    cfg, jcfg = FleetConfig(**GRIDS[1]), JFleet(**GRIDS[1])
    t = cc.CalibrationTableCache(root).load("dimm0", cfg, PhysicsParams())
    jt = jcc.CalibrationTableCache(root).load("dimm0", jcfg, JPhys())
    for now in (1.7e9, 1.7e9 + 86400.0 * 3.5, 1.0):
        assert t.age_days(now) == jt.age_days(now)
    assert t.age_days(1.7e9 + 86400.0 * 3) == 2.0
    assert t.age_days() > 0
    old = cc.CalibrationTableCache(root).load("dimm1", FleetConfig(
        **GRIDS[0]), PhysicsParams())
    assert old.calibrated_at is None and old.age_days() is None
