"""Serving meshes of logical PUD devices (port of ``repro/launch/mesh.py``:
``make_host_mesh``, ``make_mesh_for_devices`` and ``parse_mesh_spec``).

A logical PUD device is a simulated DIMM, not a card: its calibration
table, placement and packs live in tensors on some ``torch.device``.  A
``Mesh`` is the ("data", "model") grid of those positions and the card
each one sits on.  Lane ``d``, shard ``m`` goes on card ``(d * M + m) %
torch.cuda.device_count()`` unless ``devices=`` names the grid, so several
positions share a card when there are fewer cards than positions (the
port's counterpart of the reference's forced host-device meshes); on the
CPU every position is ``cpu``.  ``Mesh.describe()`` prints the map.

Device meshes are built here and nowhere else: call sites take a mesh.
The TPU pod mesh (``make_production_mesh``) and the ambient-mesh shim
(``use_mesh``) serve training only and are not part of the port.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.devices import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ("data", "model") grid of logical devices.

    ``devices[d][m]`` is the ``torch.device`` of lane ``d``, model shard
    ``m``; ``shape`` maps the axis names to their sizes, as a JAX mesh's
    does.
    """

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def describe(self) -> str:
        """The position -> card map, one ``(d, m) -> device`` per position."""
        return ", ".join(f"({d},{m})->{dev}"
                         for d, row in enumerate(self.devices)
                         for m, dev in enumerate(row))


def _grid(data: int, model: int, device) -> tuple:
    base = resolve_device(device)
    if base.type != "cuda":
        return tuple((base,) * model for _ in range(data))
    n = torch.cuda.device_count()
    return tuple(tuple(torch.device("cuda", (d * model + m) % n)
                       for m in range(model)) for d in range(data))


def make_host_mesh(data: int = 2, model: int = 2, *, device=None,
                   devices=None) -> Mesh:
    """A ``data x model`` mesh.  ``devices`` (a ``[data][model]`` grid of
    devices) places every position explicitly; otherwise positions go round
    the visible cards (``device`` None or a CUDA device; without a GPU
    ``device=None`` raises) or all sit on ``device`` when it is not CUDA."""
    if devices is not None:
        grid = tuple(tuple(torch.device(x) for x in row) for row in devices)
        if len(grid) != data or any(len(row) != model for row in grid):
            raise ValueError(f"devices is not a {data}x{model} grid")
        return Mesh(grid)
    return Mesh(_grid(data, model, device))


def make_mesh_for_devices(device=None) -> Mesh:
    """The largest ("data", "model") factorization of the visible cards,
    model axis capped at 8 (the reference launcher's default mesh); one
    position on the CPU."""
    base = resolve_device(device)
    n = torch.cuda.device_count() if base.type == "cuda" else 1
    model = 1
    for m in (8, 4, 2, 1):
        if n % m == 0 and m <= n:
            model = m
            break
    return make_host_mesh(n // model, model, device=base)


def parse_mesh_spec(spec: str, *, device=None) -> Mesh:
    """``"D,M"`` (e.g. ``--mesh 2,4``) -> a ``D x M`` mesh, the reference's
    errors for a malformed spec and for axes below 1.  Unlike the
    reference's host meshes, more positions than cards is not an error:
    positions share cards."""
    try:
        data, model = (int(p) for p in spec.split(","))
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r} is not 'DATA,MODEL' (e.g. '2,4')") from None
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {data}x{model}")
    return make_host_mesh(data, model, device=device)
