"""``repro_torch.launch.train`` on the CPU at smoke size: the loss falls
(exit 0), a run stopped at step 3 and resumed equals the uninterrupted
6-step run bit for bit (losses, batches, parameters and moments), int8
gradient compression trains, the stub frontends' inputs and the
``paper100m`` preset; the GPU is the default device."""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro_torch.configs import get  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.params import param_count  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.optim import tree_leaves, tree_map  # noqa: E402

COMMON = ["--preset", "smoke", "--global-batch", "4", "--seq-len", "64",
          "--microbatches", "2", "--log-every", "100", "--device", "cpu"]


def test_main_trains_and_returns_zero(capsys):
    assert train.main(COMMON + ["--steps", "12"]) == 0
    out = capsys.readouterr().out
    assert "[train] arch=qwen3-1.7b preset=smoke params=106,880" in out
    assert "(improved)" in out


def test_stopped_and_resumed_run_equals_uninterrupted(tmp_path):
    ck = ["--ckpt-dir", str(tmp_path), "--save-every", "3", "--steps", "6"]
    a = train.run(train.parse_args(COMMON + ck), stop_at=3)
    assert CheckpointManager(tmp_path).all_steps() == [3]
    assert len(a["losses"]) == 3 and a["ckpt"]["writes"][0]["step"] == 3
    seen = {}      # copies: run B updates the restored state in place
    b = train.run(train.parse_args(COMMON + ck + ["--resume"]),
                  on_restore=lambda tree: seen.update(tree_map(torch.clone,
                                                               tree)))
    assert b["start_step"] == 3 and len(b["losses"]) == 3
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(seen["params"]), tree_leaves(a["params"])))
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(seen["opt"]), tree_leaves(a["opt_state"])))
    assert CheckpointManager(tmp_path).all_steps() == [3, 6]
    c = train.run(train.parse_args(COMMON + ["--steps", "6"]))
    assert a["losses"] + b["losses"] == c["losses"]
    assert a["digests"] + b["digests"] == c["digests"]
    for x, y in zip(tree_leaves(b["params"]), tree_leaves(c["params"])):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(b["opt_state"]), tree_leaves(c["opt_state"])):
        assert torch.equal(x, y)
    _, _, meta = CheckpointManager(tmp_path).restore(
        {"params": b["params"], "opt": b["opt_state"]})
    assert meta["data"] == {"seed": 0, "next_step": 6}


def test_compressed_gradients_train(tmp_path):
    res = train.run(train.parse_args(
        ["--arch", "granite-8b", "--preset", "smoke", "--steps", "40",
         "--global-batch", "4", "--seq-len", "64", "--compress-grads",
         "--log-every", "100", "--device", "cpu", "--ckpt-dir",
         str(tmp_path), "--save-every", "100"]))
    assert res["rc"] == 0
    assert sorted(res["opt_state"]) == ["mu", "nu", "residual", "step"]
    # the residuals ride in the checkpoint
    names = CheckpointManager(tmp_path)._snapshot(
        {"opt": res["opt_state"]})
    assert any(k.startswith("opt/residual/") for k in names)


@pytest.mark.parametrize("arch,name,shape", [
    ("pixtral-12b", "patches", (3, 8, 32)),
    ("whisper-large-v3", "frames", (3, 16, 64)),
    ("qwen3-1.7b", None, None)])
def test_family_extras(arch, name, shape):
    spec = get(arch)
    model = spec.make_smoke()
    ex = train.family_extras(spec, model, (3, 10), step=2, seed=1)
    if name is None:
        assert ex == {}
        return
    t = ex[name]
    assert t.shape == shape and t.dtype == torch.bfloat16
    assert torch.equal(t, train.family_extras(spec, model, (3, 10), 2,
                                              seed=1)[name])
    assert not torch.equal(t, train.family_extras(spec, model, (3, 10), 3,
                                                  seed=1)[name])
    assert 0.05 < float(t.float().std()) < 0.2


def test_presets_and_default_device(monkeypatch):
    m = train.build_model("qwen3-1.7b", "paper100m")
    # the reference's comment says ~105M; its config counts 131,353,344
    assert param_count(m.param_defs()) == 131_353_344
    assert m.cfg.loss_chunk == 128
    with pytest.raises(ValueError):
        train.build_model("qwen3-1.7b", "tiny")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "smoke", "--steps", "1"])
