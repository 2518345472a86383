"""The training launcher on a CPU mesh (``launch.train.run(mesh=...)``):
a (2, 2) run stopped before step 3 after its checkpoint and resumed
equals the uninterrupted run, losses and final parameters bit for bit;
the checkpoint restores straight into shards on another mesh, equal to the
state it saved; the default mesh on the CPU is one position (plain
tensors, the one-device step); the rules are installed for the run only."""
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import sharding_ctx  # noqa: E402
from repro_torch.runtime import optim  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

ARGV = ["--arch", "qwen3-1.7b", "--preset", "smoke", "--steps", "6",
        "--global-batch", "4", "--seq-len", "32", "--microbatches", "2",
        "--log-every", "6", "--device", "cpu"]


def _leaves(tree):
    return optim.tree_leaves(shd.gather_tree(tree, "cpu"))


def test_mesh_run_cut_and_resumed_equals_uninterrupted(tmp_path):
    mesh = make_host_mesh(2, 2, device="cpu")
    full = train.run(train.parse_args(ARGV), mesh=mesh)
    assert all(shd.is_sharded(x) for x in optim.tree_leaves(full["params"]))
    held = full["bytes_per_position"]
    assert sorted(held) == mesh.positions()
    argv = ARGV + ["--ckpt-dir", str(tmp_path), "--save-every", "3"]
    a = train.run(train.parse_args(argv), mesh=mesh, stop_at=3)
    seen = {}
    b = train.run(train.parse_args(argv + ["--resume"]), mesh=mesh,
                  on_restore=lambda tree: seen.update(tree))
    assert b["start_step"] == 3
    assert all(shd.is_sharded(x) for x in optim.tree_leaves(seen))
    assert a["losses"] + b["losses"] == full["losses"]
    assert a["digests"] + b["digests"] == full["digests"]
    assert all(torch.equal(x, y) for x, y in zip(_leaves(b["params"]),
                                                 _leaves(full["params"])))
    # the step-3 checkpoint restored on a (1, 4) mesh: A's state, exactly
    other = make_host_mesh(1, 4, device="cpu")
    c = train.run(train.parse_args(ARGV + ["--ckpt-dir", str(tmp_path),
                                           "--resume", "--steps", "6"]),
                  mesh=other, stop_at=0)
    assert c["start_step"] == 6 and c["losses"] == []
    assert all(torch.equal(x, y) for x, y in zip(_leaves(c["params"]),
                                                 _leaves(full["params"])))


def test_default_mesh_on_the_cpu_is_one_position():
    sharding_ctx.set_rules(None)
    res = train.run(train.parse_args(ARGV + ["--steps", "2"]))
    assert res["mesh"].size == 1 and res["bytes_per_position"] is None
    assert not any(shd.is_sharded(x)
                   for x in optim.tree_leaves(res["params"]))
    assert sharding_ctx.get_rules() is None       # installed for the run
