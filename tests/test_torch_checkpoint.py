"""The port's checkpoints (``repro_torch/runtime/checkpoint.py``): the
reference's cases (round trip, keep-k, async, a torn write, a lost LATEST,
a shape mismatch) on the port, and interop both ways, bit for bit, bf16
included: a checkpoint written by either package restores in the other."""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.runtime.checkpoint import CheckpointManager as RefManager  # noqa
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402


def _tree(key=0):
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4) + key,
        "nested": {"b": torch.ones(5, dtype=torch.bfloat16) * (key + 1),
                   "step": torch.tensor(key, dtype=torch.int32)},
    }


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip_bf16(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(3, _tree(7), metadata={"note": "x"})
    out, step, meta = mgr.restore(_tree(0), verify=True)
    assert step == 3 and meta["note"] == "x"
    assert _equal(out, _tree(7))
    assert out["nested"]["step"].ndim == 0
    assert mgr.writes[-1]["step"] == 3 and mgr.writes[-1]["bytes"] == 62


def test_checkpoint_keep_k_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    out, step, _ = mgr.restore(_tree(0), step=3)
    assert step == 3 and _equal(out, _tree(3))


def test_checkpoint_async_overlap_and_snapshot(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    tree = _tree(1)
    mgr.save_async(1, tree)
    tree["w"].add_(100)        # the optimizer updates in place meanwhile
    mgr.save_async(2, _tree(2))   # joins the first
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    out, _, _ = mgr.restore(_tree(0), step=1)
    assert _equal(out, _tree(1))  # the snapshot taken at save_async
    out, _, _ = mgr.restore(_tree(0))
    assert _equal(out, _tree(2))


def test_checkpoint_async_error_surfaces_in_wait(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", keep=3)
    (tmp_path / "ck").rmdir()
    (tmp_path / "ck").write_text("not a directory")
    mgr.save_async(1, _tree(1))
    with pytest.raises(OSError):
        mgr.wait()


def test_checkpoint_torn_write_invisible(tmp_path):
    """A crash mid-save (a .tmp directory left behind) does not reach a
    restore, and the next save removes it."""
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree(1))
    torn = tmp_path / "step_2.tmp-999"
    torn.mkdir()
    (torn / "w.npy").write_bytes(b"garbage")
    out, step, _ = mgr.restore(_tree(0))
    assert step == 1 and _equal(out, _tree(1))
    mgr.save(2, _tree(2))
    assert not torn.exists()


def test_checkpoint_lost_latest_pointer(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, _tree(5))
    (tmp_path / "LATEST").unlink()
    assert mgr.latest_step() == 5   # falls back to a directory scan


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        mgr.restore({"v": torch.zeros(3)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"w": torch.zeros(3)})


def test_checkpoint_restores_onto_meta_template_and_device(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(4))
    tmpl = {"w": torch.empty(3, 4, device="meta"),
            "nested": {"b": torch.empty(5, device="meta"),
                       "step": torch.empty((), device="meta")}}
    out, _, _ = mgr.restore(tmpl, device="cpu")
    assert _equal(out, _tree(4))


def test_checkpoint_crc_verification_catches_a_flipped_bit(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(1))
    path = tmp_path / "step_1" / "w.npy"
    arr = np.load(path)
    arr[0, 0] += 1
    np.save(path, arr)
    mgr.restore(_tree(0))              # unverified: reads the new value
    with pytest.raises(IOError, match="crc"):
        mgr.restore(_tree(0), verify=True)


def _ref_tree(key=0):
    return {
        "w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4) + key,
        "nested": {"b": jnp.ones((5,), jnp.bfloat16) * (key + 1),
                   "step": jnp.int32(key)},
    }


def _torch_np(tree):
    """The port's tree as numpy, bf16 as its uint16 bits."""
    if isinstance(tree, dict):
        return {k: _torch_np(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(np.uint16)
    return tree.numpy()


def _ref_bits(tree):
    return jax.tree.map(
        lambda x: (np.asarray(x).view(np.uint16)
                   if x.dtype == jnp.bfloat16 else np.asarray(x)), tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, _tree(7), metadata={"data": {"seed": 0, "next_step": 3}})
    out, step, meta = RefManager(tmp_path).restore(_ref_tree(0), verify=True)
    assert step == 3 and meta == {"data": {"seed": 0, "next_step": 3}}
    assert out["nested"]["b"].dtype == jnp.bfloat16
    got, want = _ref_bits(out), _torch_np(_tree(7))
    np.testing.assert_array_equal(got["w"], want["w"])
    for k in ("b", "step"):
        assert got["nested"][k].dtype == want["nested"][k].dtype
        np.testing.assert_array_equal(got["nested"][k], want["nested"][k])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    RefManager(tmp_path).save(4, _ref_tree(5), metadata={"note": "ref"})
    out, step, meta = CheckpointManager(tmp_path).restore(_tree(0),
                                                          verify=True)
    assert step == 4 and meta == {"note": "ref"}
    assert _equal(out, _tree(5))


def test_both_packages_write_the_same_files(tmp_path):
    """The same tree saved by each package: identical manifests (crc
    included) and identical .npy bytes."""
    CheckpointManager(tmp_path / "port").save(2, _tree(3), {"k": 1})
    RefManager(tmp_path / "ref").save(2, _ref_tree(3), {"k": 1})
    a, b = tmp_path / "port" / "step_2", tmp_path / "ref" / "step_2"
    assert json.loads((a / "manifest.json").read_text()) == \
        json.loads((b / "manifest.json").read_text())
    for f in sorted(p.name for p in b.iterdir()):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_random_bf16_tree_survives_both_directions(tmp_path):
    """Random bf16 and float32 leaves (normal draws):
    port -> reference -> port, bit for bit."""
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.standard_normal((7, 9)).astype(
        np.float32)).to(torch.bfloat16),
        "b": torch.from_numpy(rng.standard_normal(33).astype(np.float32))}
    CheckpointManager(tmp_path / "one").save(1, tree)
    ref_tree, _, _ = RefManager(tmp_path / "one").restore(
        {"a": jnp.zeros((7, 9), jnp.bfloat16), "b": jnp.zeros(33)})
    RefManager(tmp_path / "two").save(1, ref_tree)
    back, _, _ = CheckpointManager(tmp_path / "two").restore(tree,
                                                             verify=True)
    assert _equal(back, tree)
