"""Where the harness finds what belongs to a cell, by name:

* ``workloads/<cell>.json``: the configuration, the traffic mix, the chips,
  the run's own settings (warm-up steps, the traced stretch, the sample
  compared) and the limits of the comparison that decides ``correct``;
* ``configs/<config>.json``: the source's keys at the top level, the
  port's departures from them under ``assumed`` (``as_run``), the port
  architecture that runs it, the grid, the packs and the plain reference
  that judges it (``reference/<module>.py``);
* ``traffic/<mix>.json``: the parameters of the one generator
  (``harness/traffic.py``);
* ``metrics/<metric>.py``: one reader per metric, ``read(run) -> float |
  None``;
* ``flops/<family>.py``: a model family's FLOP terms, ``counts(config)``
  (the configuration's ``family``);
* ``BENCHMARK.json`` at the checkout's root: which metrics the cell
  reports (a metric without ``workloads`` is every cell's).

A later cell, configuration, mix or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import pathlib
import re

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
ROOT = PACKAGE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _file(kind: str, name: str, suffix: str,
          root: pathlib.Path = ROOT) -> pathlib.Path:
    if not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = pathlib.Path(root) / PACKAGE.name / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def load_json(kind: str, name: str, root: pathlib.Path = ROOT) -> dict:
    return json.loads(_file(kind, name, ".json", root).read_text())


def benchmark(root: pathlib.Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout (required: it names the
    metrics a run reports)."""
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(kind: str, name: str, root: pathlib.Path = ROOT):
    """The Python file ``<kind>/<name>.py``, loaded from its path."""
    path = _file(kind, name, ".py", root)
    spec = importlib.util.spec_from_file_location(
        f"pudbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: pathlib.Path = ROOT):
    """The reader module ``metrics/<name>.py`` (its ``read``)."""
    mod = load_module("metrics", name, root)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{mod.__file__} defines no read(run)")
    return mod


def as_run(config: dict) -> dict:
    """The configuration as the port runs it: the source's keys, with the
    ``run`` value of each ``assumed`` entry that has one set at its key
    (a dotted key names a key of a nested group).  An ``assumed`` entry
    that is text only states what was assumed."""
    out = copy.deepcopy(config)
    for key, entry in config.get("assumed", {}).items():
        if isinstance(entry, dict) and "run" in entry:
            *head, last = key.split(".")
            d = out
            for part in head:
                d = d.setdefault(part, {})
            d[last] = copy.deepcopy(entry["run"])
    return out


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict            # workloads/<cell>.json
    config: dict              # configs/<config>.json, as run
    mix: dict                 # traffic/<mix>.json
    metrics: list             # BENCHMARK.json metric entries it reports
    root: pathlib.Path = ROOT

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def metric_entries(self, trace: bool) -> list:
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics if m["_kind"] == key]


def cell_metrics(bench: dict, name: str) -> list:
    """Every metric entry of ``bench`` that cell ``name`` reports, tagged
    with its kind."""
    out = []
    for kind in ("end_to_end", "per_layer"):
        for m in bench.get(kind, []):
            if "workloads" in m and name not in m["workloads"]:
                continue
            out.append(dict(m, _kind=kind))
    return out


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """Resolve a cell by name; its workload file must agree with its
    ``BENCHMARK.json`` entry."""
    wl = load_json("workloads", name, root)
    bench = benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"cell {name!r} is not in BENCHMARK.json")
    for key in ("config", "traffic", "chips"):
        if entries[0][key] != wl[key]:
            raise ValueError(f"cell {name!r}: {key} is {wl[key]!r} in its "
                             f"file, {entries[0][key]!r} in BENCHMARK.json")
    return Cell(name=name, workload=wl,
                config=as_run(load_json("configs", wl["config"], root)),
                mix=load_json("traffic", wl["traffic"], root),
                metrics=cell_metrics(bench, name), root=pathlib.Path(root))
