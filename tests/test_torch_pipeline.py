"""The port's GPipe schedule (``runtime/pipeline.py``) against the JAX
package's: ``bubble_fraction`` and ``stage_split`` as the reference's own
tests hold them, and ``pipelined_apply`` on four CPU stage positions equal
to the sequential application (bit for bit: every stage runs the same
layers on the same shapes) and to the reference's ``pipelined_apply``,
run in a forced four-device subprocess, within 2e-5 (float32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_cpu  # noqa: E402,F401  (one intra-op thread)

from repro.runtime.pipeline import bubble_fraction as j_bubble  # noqa: E402
from repro.runtime.pipeline import stage_split as j_split  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.mesh import make_stage_mesh  # noqa: E402
from repro_torch.runtime.pipeline import (bubble_fraction,  # noqa: E402
                                          pipelined_apply, stage_split)

TOL = 2e-5
S, L, D, MB, NM = 4, 8, 16, 2, 6


@pytest.mark.parametrize("s,b", [(1, 8), (4, 4), (2, 14), (4, 8), (3, 1)])
def test_bubble_fraction(s, b):
    assert bubble_fraction(s, b) == pytest.approx(j_bubble(s, b))
    assert bubble_fraction(4, 8) == pytest.approx(3 / 11)


def test_stage_split_shapes():
    tree = {"w": torch.zeros(8, 3, 5), "b": torch.zeros(8, 5)}
    out = stage_split(tree, 4)
    jout = j_split({"w": np.zeros((8, 3, 5)), "b": np.zeros((8, 5))}, 4)
    assert tuple(out["w"].shape) == jout["w"].shape == (4, 2, 3, 5)
    assert tuple(out["b"].shape) == jout["b"].shape == (4, 2, 5)
    with pytest.raises(ValueError, match="do not split"):
        stage_split({"w": torch.zeros(6, 2)}, 4)


def _inputs():
    rng = np.random.default_rng(0)
    ws = (0.5 * rng.standard_normal((L, D, D))).astype(np.float32)
    h = rng.standard_normal((NM, MB, D)).astype(np.float32)
    return ws, h


def _stage_fn(params, h):          # params: {"w": [L/S, D, D]}
    for w in params["w"]:
        h = torch.tanh(h @ w)
    return h


PIPE_PROG = """
    import jax, jax.numpy as jnp, numpy as np
    from repro.runtime.pipeline import pipelined_apply, stage_split

    mesh = jax.make_mesh((4,), ("stage",))
    ws, h = np.load("{ws}"), np.load("{h}")

    def stage_fn(params, x):
        def body(x, w):
            return jnp.tanh(x @ w), None
        x, _ = jax.lax.scan(body, x, params["w"])
        return x

    got = pipelined_apply(stage_fn, stage_split({{"w": jnp.asarray(ws)}}, 4),
                          jnp.asarray(h), mesh)
    np.save("{out}", np.asarray(got))
    print("PIPELINE_OK")
"""


def test_pipelined_apply_matches_sequential_and_reference(tmp_path,
                                                          forced_devices):
    ws, h = _inputs()
    mesh = make_stage_mesh(S, device="cpu")
    assert mesh.shape == {"stage": S}
    params = stage_split({"w": torch.from_numpy(ws)}, S)
    got = pipelined_apply(_stage_fn, params, torch.from_numpy(h), mesh)
    assert got.shape == (NM, MB, D)
    want = torch.stack([_stage_fn({"w": torch.from_numpy(ws)},
                                  torch.from_numpy(h[i]))
                        for i in range(NM)])
    assert torch.equal(got, want)      # the same ops on the same shapes
    paths = {n: tmp_path / f"{n}.npy" for n in ("ws", "h", "out")}
    np.save(paths["ws"], ws)
    np.save(paths["h"], h)
    forced_devices(PIPE_PROG.format(**{n: str(p) for n, p in paths.items()}),
                   marker="PIPELINE_OK", devices=4, timeout=300)
    ref = np.load(paths["out"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_pipelined_apply_needs_a_stage_mesh():
    ws, h = _inputs()
    with pytest.raises(ValueError, match="1-D"):
        pipelined_apply(_stage_fn, stage_split({"w": torch.from_numpy(ws)},
                                               2),
                        torch.from_numpy(h), make_host_mesh(2, 1,
                                                            device="cpu"),
                        stage_axis="data")


def test_one_stage_is_plain_application():
    ws, h = _inputs()
    got = pipelined_apply(_stage_fn, stage_split({"w": torch.from_numpy(ws)},
                                                 1),
                          torch.from_numpy(h), make_stage_mesh(1,
                                                               device="cpu"))
    want = torch.stack([_stage_fn({"w": torch.from_numpy(ws)},
                                  torch.from_numpy(x)) for x in h])
    assert torch.equal(got, want)
