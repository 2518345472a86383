"""Every cell, configuration, mix and metric of BENCHMARK.json resolves by
name, and a new cell, configuration, mix and metric are picked up as new
files alone."""
import json
import pathlib
import shutil

import pytest

from pudbench.harness import counts, spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.config["port"]["arch"]
    assert c.mix["clients"] >= 1
    kinds = {m["_kind"] for m in c.metrics}
    assert kinds == {"end_to_end", "per_layer"}
    assert any(m["name"] == "setup_s" for m in c.metrics)
    for m in c.metrics:
        assert callable(spec.load_metric(m["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_matches_its_entry(entry):
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert entry["file"] == f"pudbench/configs/{entry['name']}.json"


def test_every_metric_has_a_reader():
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    files = {p.stem for p in (ROOT / "pudbench" / "metrics").glob("*.py")}
    assert set(names) <= files


def test_new_files_alone_add_a_cell(tmp_path):
    """A copy of the checkout's benchmark, plus a mix, a configuration of
    a new model family (its FLOP terms), a metric and a cell as new files
    and entries: the cell resolves, counts its model's FLOPs and reports
    the new metric; no existing file changes."""
    shutil.copytree(ROOT / "pudbench", tmp_path / "pudbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "pudbench").rglob("*")
              if p.is_file()}
    d = tmp_path / "pudbench"
    mix = json.loads((d / "traffic" / "rag.json").read_text())
    mix["clients"] = 32
    (d / "traffic" / "rag-half.json").write_text(json.dumps(mix))
    cfg = json.loads((d / "configs" / "deepseek-v2-lite-16b.json")
                     .read_text())
    cfg["family"] = "dense_copy"
    cfg["assumed"]["ffn_only"] = {"run": True, "why": "a new family"}
    (d / "configs" / "deepseek-v2-lite-16b-copy.json").write_text(
        json.dumps(cfg))
    (d / "flops" / "dense_copy.py").write_text(
        "def counts(c):\n"
        "    per = 2 * 3 * c['hidden_size'] * c['intermediate_size']\n"
        "    return dict(per_token=per * c['num_hidden_layers'],\n"
        "                unembed=2 * c['hidden_size'] * c['vocab_size'],\n"
        "                prompt_attn=0, decode_attn=0)\n")
    (d / "metrics" / "engine.steps.py").write_text(
        "def read(run):\n    return float(len(run['window'].steps))\n")
    (d / "workloads" / "dsv2lite-half.json").write_text(json.dumps(
        {"config": "deepseek-v2-lite-16b-copy", "traffic": "rag-half",
         "chips": 1, "warmup_steps": 4, "trace": {"steps": 2},
         "compare_requests": 4,
         "correct": {"widest_gap": 1.0, "bookkeeping": 0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "dsv2lite-half",
                               "config": "deepseek-v2-lite-16b-copy",
                               "traffic": "rag-half", "chips": 1,
                               "why": "half the clients"})
    bench["per_layer"].append({"name": "engine.steps", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "gen_tok_s",
                               "workloads": ["dsv2lite-half"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("dsv2lite-half", root=tmp_path)
    assert c.mix["clients"] == 32
    assert c.config["hidden_size"] == 2048
    assert c.config["ffn_only"] is True
    per = 2 * 3 * 2048 * 10944 * 27
    assert counts.model_flops(c.config, decode_positions=[5],
                              root=tmp_path) == per + 2 * 2048 * 102400
    names = [m["name"] for m in c.metric_entries(trace=True)]
    assert "engine.steps" in names
    rd = spec.load_metric("engine.steps", root=tmp_path)

    class W:
        steps = [1, 2, 3]
    assert rd.read({"window": W}) == 3.0
    # the existing cells do not report the new cell's metric
    old = spec.load_cell("dsv2lite-rag", root=tmp_path)
    assert "engine.steps" not in [m["name"] for m in old.metrics]
    for p, data in before.items():
        assert p.read_bytes() == data


def test_the_source_keys_stay_and_assumed_sets_what_is_run():
    """A configuration file holds its source's keys; the port's
    departures, under ``assumed``, are what the run sees."""
    raw = spec.load_json("configs", "mamba2-1.3b")
    assert raw["reduced"] == [] and raw["vocab_size"] == 50277
    assert raw["ssm_cfg"] == {"layer": "Mamba2"}
    run = spec.as_run(raw)
    assert run["vocab_size"] == 50280 and run["residual_in_fp32"] is False
    assert run["ssm_cfg"]["d_state"] == 128
    assert run["ssm_cfg"]["chunk_size"] == 128
    assert raw["ssm_cfg"] == {"layer": "Mamba2"}          # not mutated
    ds = spec.as_run(spec.load_json("configs", "deepseek-v2-lite-16b"))
    assert ds["norm_topk_prob"] is True and ds["rope_scaling"] is None
    assert spec.load_cell("mamba2-longdoc").config == run


def test_unknown_cell_and_bad_names_are_refused():
    with pytest.raises(FileNotFoundError):
        spec.load_cell("no-such-cell")
    with pytest.raises(ValueError):
        spec.load_json("traffic", "../rag")
