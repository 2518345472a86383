"""``train_loss`` and its gradients in both packages for the MoE archs
(deepseek-v2-lite-16b with MLA, llama4-scout-17b-a16e): routing, the
dispatch's scatter and the aux loss, at smoke size (``tests/_train.py``:
float32 within 1e-4, bf16 against the reference run op by op within the
stated tolerances)."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _train import check_train_loss  # noqa: E402

ARCHS = ['deepseek-v2-lite-16b', 'llama4-scout-17b-a16e']


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_f32(arch):
    check_train_loss(arch, f32=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference_op_by_op_bf16(arch):
    check_train_loss(arch, f32=False)
