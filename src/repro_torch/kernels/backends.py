"""Named execution backends for the bit-plane GEMM (port of
``repro/kernels/backends.py``).

  * ``reference`` — the plain PyTorch versions (kernels/ref.py), any device.
  * ``cuda``      — the hand-written placed kernels (kernels/placed_gemm.py).
    A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
    version.  The unplaced kernels are not ported yet: the ``cuda`` backend
    raises for an unplaced pack on the GPU.

Every entry takes ``x [B, K] int8`` and planes/words and returns ``[B, N]``
int32; all backends give identical integers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import placed_gemm, ref

DEFAULT_BACKEND = "cuda"


@dataclasses.dataclass(frozen=True)
class Backend:
    """One named lowering: ``gemv``/``gemv_placed`` for B = 1 and
    ``gemm``/``gemm_placed`` for B > 1, all with the layout keywords
    ``layout``, ``logical_k`` and (placed) ``window_block``."""

    name: str
    gemv: Callable[..., torch.Tensor]
    gemv_placed: Callable[..., torch.Tensor]
    gemm: Callable[..., torch.Tensor]
    gemm_placed: Callable[..., torch.Tensor]


def _ref_unplaced(x, planes, mode="folded", *, layout="dense",
                  logical_k=None):
    x, planes = ref.densify(x, planes, layout, logical_k)
    return ref.bitplane_gemv_ref(x, planes)


def _cuda_unplaced(x, planes, mode="folded", *, layout="dense",
                   logical_k=None):
    if x.is_cuda:
        raise NotImplementedError(
            "the unplaced bit-plane GEMM/GEMV kernels are not ported to CUDA "
            "yet; pack with a placement or use backend='reference'")
    return _ref_unplaced(x, planes, mode, layout=layout, logical_k=logical_k)


_REGISTRY: dict[str, Backend] = {
    "reference": Backend("reference", gemv=_ref_unplaced,
                         gemv_placed=placed_gemm.placed_plain,
                         gemm=_ref_unplaced,
                         gemm_placed=placed_gemm.placed_plain),
    "cuda": Backend("cuda", gemv=_cuda_unplaced,
                    gemv_placed=placed_gemm.gemv_placed,
                    gemm=_cuda_unplaced,
                    gemm_placed=placed_gemm.gemm_placed),
}


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; registered: "
                       f"{backend_names()}") from None


def backend_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
