"""The CPU rehearsal of ``chip_smoke.py``: one group of its phases at smoke
size through the plain versions (``chip_smoke.run(only=[group])``).

Each ``tests/test_torch_rehearsal_<group>.py`` drives one group, so
``pytest --dist loadfile`` spreads the groups over its workers.  The scales
here are the CPU's; the card's (``GRID``, ``TABLE1``, ``GEMMA``, ...) are
``chip_smoke.py``'s own.  Like every port test, a group runs on one
intra-op thread (``tests/_torch_cpu.py``): with five groups at once on
an 8-core machine and PyTorch's default of one thread per core, the
fleet group took 471 s; on one thread, 17 s.
"""
import importlib.util
import pathlib

import torch

import _torch_cpu  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL_GRID = dict(n_channels=1, n_banks=1, n_subarrays=8, n_cols=512)
#: gemma's and deepseek's smoke grid (they place 1,664 and 1,024 columns)
MODEL_GRID = dict(n_channels=1, n_banks=1, n_subarrays=4, n_cols=512)


def chip_smoke():
    """``chip_smoke.py`` loaded as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cpu_scales(cs) -> dict:
    """``chip_smoke.run``'s keyword arguments at the rehearsal's scales."""
    from repro_torch.core.calibrate import CalibrationConfig
    return dict(
        preset="smoke", grid=SMALL_GRID,
        table1=dict(n_cols=512, n_trials_maj5=256, n_cols_arith=32,
                    n_trials_arith=32),
        table1_calib=CalibrationConfig(n_iterations=8, n_samples=128),
        quickstart=dict(n_channels=1, n_banks=1, n_subarrays=2, n_cols=512),
        simra=dict(n_cols=2048, events=64),
        dense_cfg=dict(b=4, k=256, n=512, wb=4),
        sense_shapes=[(1, 8, 2048, 3), (16, 8, 512, 0), (3, 5, 100, 3)],
        calib_shapes=[(4, 512, 5, 256), (3, 64, 5, 1001)],
        fleet_argv=["--subarrays", "4", "--n-cols", "256", "--n-trials",
                    "256", "--check-full", "--device", "cpu"],
        recal=(3, 5),
        gemma=dict(cs.GEMMA, preset="smoke", grid=MODEL_GRID),
        deepseek=dict(cs.DEEPSEEK, preset="smoke", grid=MODEL_GRID),
        figures=dict(n_cols=64, n_trials_maj5=32, check_plain=True),
        fleet=dict(cs.FLEET, preset="smoke", grid=SMALL_GRID,
                   widen=dict(d_ff=512, vocab=512), prompt=8, gen=4,
                   ragged=dict(n=6, prompt=(4, 12), budget=(2, 6))),
        families=dict(cs.FAMILIES, preset="smoke", grid=SMALL_GRID,
                      prompt=8, gen=4,
                      ragged=dict(n=6, prompt=(4, 12), budget=(2, 6))),
        train=dict(cs.TRAIN, preset="smoke", seq_len=64, global_batch=8,
                   microbatches=2),
        mesh=dict(
            train=dict(cs.MESH["train"], preset="smoke", seq_len=64,
                       global_batch=8, microbatches=2),
            pipeline=dict(cs.MESH["pipeline"], preset="smoke", seq=16,
                          rows=2, stages=2),     # the smoke qwen3: 2 layers
            fleet=dict(cs.MESH["fleet"], preset="smoke", grid=SMALL_GRID,
                       widen=dict(vocab=512), prompt=8, gen=4)),
        dryrun=dict(cs.DRYRUN, preset="smoke",
                    train=dict(seq_len=64, global_batch=8, microbatches=2),
                    decode=dict(seq_len=64, batch=4, steps=2),
                    cells=(("mamba2-1.3b", "long_500k"),
                           ("qwen3-1.7b", "decode_32k")),
                    families=dict(
                        cs.DRYRUN["families"],
                        vlm=dict(cs.DRYRUN["families"]["vlm"], seq_len=64),
                        train=dict(cs.DRYRUN["families"]["train"],
                                   seq_len=16),
                        hybrid=dict(cs.DRYRUN["families"]["hybrid"],
                                    seq_len=64, train=dict(
                                        cs.DRYRUN["families"]["hybrid"][
                                            "train"], seq_len=32)))))


def rehearse(group: str, capsys, tmp_path, monkeypatch):
    """Run one group on the CPU; returns (run's output, printed text)."""
    from repro_torch.benchmarks import common
    monkeypatch.setattr(common, "ART", tmp_path)
    cs = chip_smoke()
    out = cs.run(torch, torch.device("cpu"), only=[group], **cpu_scales(cs))
    return out, capsys.readouterr().out


def check_rows(out, names, shape_counts) -> None:
    """The group's kernel rows: these kernels, this many shapes each
    (head and extras), every shape exact against its plain version with a
    positive bound."""
    rows = out["rows"]
    assert [r["name"] for r in rows] == names
    assert [1 + len(r["extra_shapes"]) for r in rows] == shape_counts
    for r in rows:
        for e in [r] + r.get("extra_shapes", []):
            assert e["max_abs_err"] == 0 and e["bound_ms"] > 0
            assert e["bound_by"] in ("bytes", "operations")
