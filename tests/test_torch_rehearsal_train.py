"""``chip_smoke.py``'s train group on the CPU at smoke size: qwen3's run A
(stopped at step 3 after an async checkpoint), run B resumed from it, run
C uninterrupted and profiled, then every arch's smoke step in float32 and
bf16 (on the CPU against itself, so exact)."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _rehearsal import rehearse  # noqa: E402


def test_train_group_rehearses_on_cpu(capsys, tmp_path, monkeypatch):
    out, text = rehearse("train", capsys, tmp_path, monkeypatch)
    assert out["rows"] == []          # the group launches no kernel
    tr = out["train"]
    assert len(tr["a"]["losses"]) == 3 and len(tr["b"]["losses"]) == 3
    assert tr["a"]["losses"] + tr["b"]["losses"] == tr["c"]["losses"]
    assert tr["loss_err"] == (0.0, 0.0)
    assert tr["b"]["restored"]["equal"] == tr["b"]["restored"]["leaves"] > 0
    assert tr["a"]["ckpt"]["writes"][0]["step"] == 3
    assert len(tr["smoke"]) == 20
    assert all(r["loss_err"] == 0 and r["grad_ratio"] == 0
               for r in tr["smoke"].values())
    assert "batches of B (steps 3-5) == C's, bit for bit" in text
    assert text.count("(phase wall") == 5      # and the kernel rows
