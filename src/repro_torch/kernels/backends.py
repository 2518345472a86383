"""Named execution backends for the kernels (port of
``repro/kernels/backends.py``).

  * ``reference`` — the plain PyTorch versions (kernels/ref.py), any device.
  * ``cuda``      — the hand-written kernels: unplaced packs in
    kernels/plane_gemm.py, placed ones in kernels/placed_gemm.py, SiMRA
    sensing in kernels/sense.py and the fused calibration iteration in
    kernels/calib_iter.py.  A CUDA tensor launches the kernel or raises; a
    CPU tensor runs the plain version.

Every GEMM entry takes ``x [B, K] int8`` and planes/words and returns
``[B, N]`` int32; all backends give identical integers, and identical bits
and levels from ``majx_sense`` and ``calib_iter``.  ``register_backend``
adds another (a name once); one without GEMM entries serves batches
through its GEMV entry.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import calib_iter, placed_gemm, plane_gemm, sense

DEFAULT_BACKEND = "cuda"


@dataclasses.dataclass(frozen=True)
class Backend:
    """One named lowering: ``gemv``/``gemv_placed`` for B = 1 and
    ``gemm``/``gemm_placed`` for B > 1, all with the layout keywords
    ``layout``, ``logical_k`` and (placed) ``window_block`` and a
    ``tile_plan`` (``kernels/autotune.TunedPlan``, or None); ``majx_sense``
    and ``calib_iter`` with the signatures of kernels/sense.py and
    kernels/calib_iter.py.  A backend without GEMM entries (None) serves
    B > 1 through its GEMV entry (``matmul`` / ``matmul_placed``)."""

    name: str
    gemv: Callable[..., torch.Tensor]
    gemv_placed: Callable[..., torch.Tensor]
    majx_sense: Callable[..., torch.Tensor]
    calib_iter: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    gemm: Callable[..., torch.Tensor] | None = None
    gemm_placed: Callable[..., torch.Tensor] | None = None

    def matmul(self, x, planes, mode="folded", **kw):
        """Batch-tiled entry, falling back to the GEMV entry."""
        return (self.gemm or self.gemv)(x, planes, mode, **kw)

    def matmul_placed(self, x, planes, col_ids, mode="folded", **kw):
        return (self.gemm_placed or self.gemv_placed)(x, planes, col_ids,
                                                      mode, **kw)


def _ignores_plan(fn):
    """A plain version as a backend entry: a launch plan is an execution
    choice of the kernels, which the plain versions do not make, so it is
    taken and dropped (every plan gives the same integers)."""
    def entry(*args, tile_plan=None, **kw):
        return fn(*args, **kw)
    entry.__name__ = entry.__qualname__ = fn.__name__
    return entry


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    """Register a named backend; a name is registered once."""
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


register_backend(Backend(
    "reference", gemv=_ignores_plan(plane_gemm.gemv_plain),
    gemv_placed=_ignores_plan(placed_gemm.gemv_placed_plain),
    gemm=_ignores_plan(plane_gemm.gemm_plain),
    gemm_placed=_ignores_plan(placed_gemm.gemm_placed_plain),
    majx_sense=sense.majx_sense_plain, calib_iter=calib_iter.calib_iter_plain))
register_backend(Backend(
    "cuda", gemv=plane_gemm.gemv, gemv_placed=placed_gemm.gemv_placed,
    gemm=plane_gemm.gemm, gemm_placed=placed_gemm.gemm_placed,
    majx_sense=sense.majx_sense, calib_iter=calib_iter.calib_iter))


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{backend_names()}") from None


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
