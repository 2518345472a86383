"""Named execution backends for the bit-plane GEMM (port of
``repro/kernels/backends.py``).

  * ``reference`` — the plain PyTorch versions (kernels/ref.py), any device.
  * ``cuda``      — the hand-written kernels: unplaced packs in
    kernels/plane_gemm.py, placed ones in kernels/placed_gemm.py.  A CUDA
    tensor launches the kernel or raises; a CPU tensor runs the plain
    version.

Every entry takes ``x [B, K] int8`` and planes/words and returns ``[B, N]``
int32; all backends give identical integers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import placed_gemm, plane_gemm

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


_REGISTRY: dict[str, Backend] = {
    "reference": Backend("reference", gemv=plane_gemm.gemv_plain,
                         gemv_placed=placed_gemm.gemv_placed_plain,
                         gemm=plane_gemm.gemm_plain,
                         gemm_placed=placed_gemm.gemm_placed_plain),
    "cuda": Backend("cuda", gemv=plane_gemm.gemv,
                    gemv_placed=placed_gemm.gemv_placed,
                    gemm=plane_gemm.gemm,
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
