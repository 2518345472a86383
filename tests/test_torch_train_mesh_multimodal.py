"""The sharded train step on (2, 2), (1, 4) and (4, 1) CPU meshes for
the encoder-decoder and VLM archs (whisper-large-v3, pixtral-12b),
whose stub frontends' inputs split over the lanes with the rows, against the
reference's jitted single-device step and the port's one-device step over
3 steps at 1 and 2 microbatches (float32), and one bf16 microbatch pass
against the reference run op by op (tolerances in ``tests/_mesh.py``)."""
import pytest

pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from _mesh import check_bf16_grads, check_trajectory  # noqa: E402

ARCHS = ['whisper-large-v3', 'pixtral-12b']


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference_f32(arch, k):
    check_trajectory(arch, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_grads_match_reference_op_by_op_bf16(arch):
    check_bf16_grads(arch)
