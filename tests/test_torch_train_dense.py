"""``train_loss`` and its gradients in both packages for the dense GQA
archs (qwen3-1.7b, gemma-7b, granite-8b, deepseek-67b), at smoke size
(``tests/_train.py``: float32 within 1e-4, bf16 against the reference run
op by op within the stated tolerances)."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _train import check_train_loss  # noqa: E402

ARCHS = ['qwen3-1.7b', 'gemma-7b', 'granite-8b', 'deepseek-67b']


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_f32(arch):
    check_train_loss(arch, f32=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_op_by_op_bf16(arch):
    check_train_loss(arch, f32=False)
