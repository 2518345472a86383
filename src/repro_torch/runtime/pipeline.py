"""GPipe pipeline parallelism over a "stage" mesh axis (port of
``repro/runtime/pipeline.py``).

The layer stack splits into S stages (``stage_split``: [L, ...] ->
[S, L/S, ...]); stage ``s``'s parameters live on the device of position
``s`` of a ("stage",) mesh (``launch/mesh.make_stage_mesh``), and
microbatches flow through the stages on the standard fill-drain schedule:
at tick t stage s works on microbatch t - s, and its output moves to
stage s + 1's device for the next tick.  B microbatches take B + S - 1
ticks, so the bubble is (S - 1) / (B + S - 1) (``bubble_fraction``).

One process drives every stage (no ``torch.distributed``): within a tick
the stages are issued one after another from the host, and on several
cards they still overlap, since CUDA launches are asynchronous.  A stage
computes exactly the layers it would run in a sequential application, on
the same shapes, so the result equals that application bit for bit on one
device type.  The output is the last stage's result for every microbatch,
in order, on the first stage's device (the reference replicates it over
the stage axis with a ``psum``; every position reads the same values).

``pipelined_apply`` is model-agnostic: it takes ``stage_fn(stage_params,
h) -> h`` (one stage's layer run) and composes the schedule around it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.params import tree_map


def _to(tree, device):
    return tree_map(lambda x: x.to(device), tree)


def pipelined_apply(stage_fn: Callable, stage_params, h: torch.Tensor,
                    mesh, stage_axis: str = "stage") -> torch.Tensor:
    """Run ``h`` [n_micro, micro_batch, ...] through the S stages of
    ``stage_params`` (a tree of [S, ...] leaves) with the GPipe fill-drain
    schedule over ``mesh``'s ``stage_axis``.  Returns [n_micro, ...]: the
    last stage's output for every microbatch, in order."""
    names = mesh.axis_names
    n_stages = mesh.shape[stage_axis]
    if names != (stage_axis,):
        raise ValueError(f"pipelined_apply needs a 1-D ({stage_axis!r},) "
                         f"mesh, got axes {names}")
    devs = [mesh.device((s,)) for s in range(n_stages)]
    local = [_to(tree_map(lambda x, s=s: x[s], stage_params), devs[s])
             for s in range(n_stages)]
    n_micro = h.shape[0]
    out: list = [None] * n_micro
    inflight: list = [None] * n_stages     # each stage's input this tick
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:                     # stage 0 injects microbatch t
            inflight[0] = h[t].to(devs[0])
        nxt: list = [None] * n_stages
        for s in range(n_stages):
            if inflight[s] is None:         # fill / drain: idle
                continue
            y = stage_fn(local[s], inflight[s])
            if s == n_stages - 1:           # bank microbatch t - (S - 1)
                out[t - s] = y
            else:                           # shift to the next stage
                nxt[s + 1] = y.to(devs[s + 1])
        inflight = nxt
    return torch.stack([y.to(devs[0]) for y in out])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: idle ticks / total ticks."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stage_split(defs_or_params, n_stages: int):
    """Split a layer-stacked tree [L, ...] into [S, L/S, ...]."""
    def one(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             "stages")
        return x.reshape((n_stages, n // n_stages) + tuple(x.shape[1:]))
    return tree_map(one, defs_or_params)
