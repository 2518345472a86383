"""``chip_smoke.py``'s dryrun group on the CPU at smoke size: the dry
run's prediction of qwen3's train step and decode steps on a (1, 1) mesh
against the profiler's FLOP count of the same steps run on the CPU (peaks
and device times are the card's), then two full-size cells of the grid
and the roofline over their records, then the same train step and decode
lane split over a (1, 4) mesh's "model" positions, and (f)-(i) the other
families' split on that mesh: mamba2's and pixtral's decode lanes, whisper's
train step, zamba2's decode lane and float32 train step (the float32
split equal to the unsplit run)."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import rehearse  # noqa: E402


def test_dryrun_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    from repro_torch.benchmarks import roofline
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun, "ART", tmp_path / "dryrun")
    monkeypatch.setattr(roofline, "ART", tmp_path / "dryrun")
    out, text = rehearse("dryrun", capsys, tmp_path, monkeypatch)
    assert out["rows"] == []          # the group launches no kernel
    dr = out["dryrun"]
    tr = dr["train"]
    assert tr["measured"]["flops"] == tr["record"]["flops_per_device"] > 0
    assert tr["record"]["microbatch"] == 2 and tr["record"]["lanes"] == 1
    assert dr["decode"]["record"]["flops_per_device"] > 0
    assert len(dr["decode"]["device_ms"]) == 2
    assert dr["decode"]["measured"]["flops"] == \
        dr["decode"]["record"]["flops_per_device"]
    assert sorted(dr["grid"]) == ["mamba2-1.3b/long_500k",
                                  "qwen3-1.7b/decode_32k"]
    assert "(a) train step: FLOPs predicted" in text
    assert "(+0.0000%; matrix products)" in text
    assert "| qwen3-1.7b | decode_32k | base |" in text
    assert "measured device time not measured" in text
    sp = dr["split"]
    assert sp["train"]["measured"]["flops"] == \
        4 * sp["train"]["record"]["flops_per_device"] > 0
    assert abs(sp["train"]["loss"] - tr["first_loss"]) < 1e-3
    assert sp["decode"]["steps_equal"] + sp["decode"]["ties"] == 8 and \
        sp["decode"]["logits_err"] < 0.05
    assert sp["decode"]["overrides"] == {"heads": None, "kv_heads": None,
                                         "kv_seq": "model"}
    assert "(d) FLOPs: the dry run's per position" in text
    assert "(e) 8 steps, the split lane fed the unsplit lane's tokens" in text
    for lab, key in (("(f)", "ssm"), ("(h)", "vlm")):
        fam = sp[key]
        assert fam["steps_equal"] + fam["ties"] == 8, key
        assert fam["logits_err"] <= max(fam["allowed"]), key
        assert f"{lab} 8 steps, the split lane fed the unsplit lane's" in text
        assert fam["f32_err"] <= 5e-3 and len(fam["bf16_gap"]) == 8, key
    assert sp["vlm"]["overrides"]["kv_seq"] == "model"
    enc = sp["encdec"]
    assert enc["measured"]["flops"] == \
        4 * enc["record"]["flops_per_device"] > 0
    assert enc["record"]["scheme"] == dryrun.SCHEME_SPLIT
    ls = enc["losses"]
    assert abs(ls["split float32"] - ls["one float32"]) <= enc["allowed32"]
    assert abs(ls["split"] - ls["one"]) <= enc["allowed"]
    assert enc["allowed32"] == 2e-4 + 2e-4 * ls["one float32"]
    assert "(g) FLOPs: the dry run's per position" in text
    hy = sp["hybrid"]             # (i): zamba2's float32 split is exact
    assert hy["steps_equal"] + hy["ties"] == 8
    assert hy["f32_equal"] == 8 and hy["f32_err"] == 0.0
    assert "(i) 8 steps, the split lane fed the unsplit lane's" in text
    ht = sp["hybrid_train"]
    assert ht["record"]["scheme"] == dryrun.SCHEME_SPLIT
    assert ht["runs"]["split"]["flops"] == 4 * (
        ht["record"]["flops_per_device"]
        - ht["record"]["conv_flops_per_device"]) > 0
    assert ht["runs"]["split"]["loss"] == ht["runs"]["one"]["loss"]
    assert "(i) FLOPs: the dry run's per position" in text
    assert text.count("(phase wall") == 11     # and the kernel rows
