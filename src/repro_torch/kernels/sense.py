"""SiMRA sensing of T events over C columns: CUDA kernel wrapper, plain
version, counter.

Replaces the Pallas kernel ``repro/kernels/majx.py: majx_sense``.  The
kernel source is ``csrc/simra_sense.cu``; ``majx_sense_plain`` is the plain
PyTorch version (``kernels/ref.majx_sense_ref``) it is held against.  The
command-level simulator's ``simra`` (pud/device.py) senses through it, one
event per call.

A CUDA tensor launches the kernel (and raises on anything it does not
take); a CPU tensor runs the plain version.  Any T and C launch: the TPU
kernel's ``T % 8 == 0`` and ``C % 1024 == 0`` contract is a TPU tiling rule,
and the CUDA kernel masks its ragged edge instead.

``plan_launch`` makes the launch geometry on the host (threads per block,
column blocks, event rows); the kernel only checks it, so the CPU tests
reach it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.pud.physics import NEUTRAL, PhysicsParams

from . import build
from .placed_gemm import _cdiv
from .ref import majx_sense_ref

majx_sense_plain = majx_sense_ref

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p

THREADS = 256                 # threads per block, one column each
MAX_GRID_Y = 65535            # event rows of the grid; blocks stride past


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch of ``csrc/simra_sense.cu`` covers [T, C]: one thread
    per column of ``threads``-column blocks; block (x, y) takes events y,
    y + grid[1], ... of its columns."""
    threads: int
    grid: tuple[int, int]

    #: field order of the C ``Plan`` struct (the grid follows)
    FIELDS = ("threads",)

    def c_array(self):
        vals = [int(getattr(self, f)) for f in self.FIELDS] + list(self.grid)
        return (ctypes.c_int * len(vals))(*vals)


@functools.lru_cache(maxsize=256)
def plan_launch(t: int, c: int) -> Plan:
    """The launch plan of ``t`` events over ``c`` columns: one event per
    block row up to ``MAX_GRID_Y`` (the simulator's T = 1 at C = 65,536
    gives 256 blocks, about two per SM).  Wider threads (float4 columns)
    and blocks that walk several events measured no faster (PERF.md
    §6)."""
    return Plan(THREADS, (_cdiv(c, THREADS), min(t, MAX_GRID_Y)))


def _lib():
    fn = build.load("simra_sense").simra_sense_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 4 + [_I] * 3 + [_F] * 7 + [_P, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def majx_sense(charge: torch.Tensor, sense_offset: torch.Tensor,
               noise: torch.Tensor, params: PhysicsParams = PhysicsParams(),
               n_fracs: int = 0) -> torch.Tensor:
    """Sensed bits [T, C] float32, equal to ``majx_sense_plain`` bit for
    bit."""
    if not charge.is_cuda:
        return majx_sense_plain(charge, sense_offset, noise, params, n_fracs)

    def need(cond, msg):
        if not cond:
            raise ValueError(f"majx_sense: {msg}")

    need(charge.dim() == 3, f"charge must be [T, R, C], got "
         f"{tuple(charge.shape)}")
    t, r, c = charge.shape
    need(t > 0 and r > 0 and c > 0, "empty operand")
    need(sense_offset.shape == (c,), f"sense_offset must be [{c}]")
    need(noise.shape == (t, c), f"noise must be [{t}, {c}]")
    for x in (charge, sense_offset, noise):
        need(x.dtype == torch.float32, "tensors must be float32")
        need(x.device == charge.device, "all tensors on one device")
        need(x.is_contiguous(), "tensors must be contiguous")
    f = np.float32
    out = torch.empty((t, c), dtype=torch.float32, device=charge.device)
    arr = plan_launch(t, c).c_array()
    fn = _lib()
    with torch.cuda.device(charge.device):
        stream = torch.cuda.current_stream(charge.device).cuda_stream
        rc = fn(charge.data_ptr(), sense_offset.data_ptr(), noise.data_ptr(),
                out.data_ptr(), t, r, c,
                float(f(params.c_cell_ff)),
                float(f(NEUTRAL * params.c_bitline_ff)),
                float(f(r * params.c_cell_ff + params.c_bitline_ff)),
                float(f(NEUTRAL)), 2.0,
                float(f(params.sigma_dynamic ** 2
                        + params.sigma_frac ** 2 * float(n_fracs))),
                float(f(params.sigma_transfer ** 2)), arr, len(arr), stream)
    if rc != 0:
        raise RuntimeError(f"majx_sense kernel launch failed: CUDA error {rc}")
    majx_sense.launches += 1
    return out


majx_sense.launches = 0
