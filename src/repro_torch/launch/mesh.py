"""Meshes of logical positions (port of ``repro/launch/mesh.py``:
``make_production_mesh``, ``make_host_mesh``, ``make_mesh_for_devices``,
``parse_mesh_spec`` and ``use_mesh``).

A position is a logical device: a simulated DIMM of the serving fleet, or
a holder of parameter and optimizer shards in training.  Its tensors live
on some ``torch.device``.  A ``Mesh`` is the grid of those positions over
named axes -- ``("data", "model")``, ``("pod", "data", "model")`` or the
pipeline's ``("stage",)`` -- and the card each one sits on.  Position
``i`` in row-major order goes on card ``i % torch.cuda.device_count()``
unless ``devices=`` names the grid, so several positions share a card when
there are fewer cards than positions (the port's counterpart of the
reference's forced host-device meshes); on the CPU every position is
``cpu``.  ``Mesh.describe()`` prints the map.

``use_mesh`` installs an ambient mesh in this package's own context
variable (``current_mesh`` reads it); nothing here touches
``torch.distributed``.  Device meshes are built here and nowhere else:
call sites take a mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math

import torch

from repro_torch.devices import resolve_device


def _nest(flat: list, shape: tuple) -> tuple:
    if len(shape) == 1:
        return tuple(flat)
    step = len(flat) // shape[0]
    return tuple(_nest(flat[i * step:(i + 1) * step], shape[1:])
                 for i in range(shape[0]))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of logical positions over named axes.

    ``devices`` nests one tuple level per axis: ``devices[d][m]`` is the
    ``torch.device`` of lane ``d``, model shard ``m`` of a ("data",
    "model") mesh.  ``shape`` maps the axis names to their sizes, as a JAX
    mesh's does.
    """

    devices: tuple
    axis_names: tuple[str, ...] = ("data", "model")

    def __post_init__(self):
        dims, level = [], self.devices
        for _ in self.axis_names:
            if not isinstance(level, tuple) or not level:
                raise ValueError(f"devices do not nest {len(self.axis_names)}"
                                 f" levels for axes {self.axis_names}")
            dims.append(len(level))
            level = level[0]
        if len(self.flat_devices()) != math.prod(dims):
            raise ValueError(f"devices are not a {tuple(dims)} grid")

    @property
    def shape(self) -> dict[str, int]:
        dims, level = {}, self.devices
        for name in self.axis_names:
            dims[name] = len(level)
            level = level[0]
        return dims

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def positions(self) -> list[tuple[int, ...]]:
        """Every position's coordinates, row-major."""
        return list(itertools.product(*(range(n) for n in
                                        self.shape.values())))

    def device(self, coord: tuple[int, ...]) -> torch.device:
        level = self.devices
        for i in coord:
            level = level[i]
        return level

    def flat_devices(self) -> list[torch.device]:
        """The positions' devices, row-major."""
        def walk(level):
            if isinstance(level, tuple):
                return [d for x in level for d in walk(x)]
            return [level]
        return walk(self.devices)

    def describe(self) -> str:
        """The position -> card map, one ``(i,j,...) -> device`` each."""
        return ", ".join(f"({','.join(map(str, c))})->{self.device(c)}"
                         for c in self.positions())


def _round_robin(shape: tuple, device) -> tuple:
    base = resolve_device(device)
    n = math.prod(shape)
    if base.type != "cuda":
        flat = [base] * n
    else:
        cards = torch.cuda.device_count()
        flat = [torch.device("cuda", i % cards) for i in range(n)]
    return _nest(flat, shape)


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], *,
              device=None) -> Mesh:
    """A mesh of ``shape`` positions over ``axis_names``, going round the
    visible cards (``device`` None or a CUDA device; without a GPU
    ``device=None`` raises), or all on ``device`` when it is not CUDA."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape} for axes {axis_names}")
    return Mesh(_round_robin(shape, device), axis_names)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's pod meshes: (data 16, model 16), or (pod 2, data
    16, model 16), as positions over the visible cards."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"),
                         device=device)
    return make_mesh((16, 16), ("data", "model"), device=device)


def make_stage_mesh(n_stages: int, *, device=None) -> Mesh:
    """A 1-D ("stage",) mesh for ``runtime/pipeline.pipelined_apply`` (the
    reference's test builds ``jax.make_mesh((4,), ("stage",))``)."""
    return make_mesh((n_stages,), ("stage",), device=device)


def make_host_mesh(data: int = 2, model: int = 2, *, device=None,
                   devices=None) -> Mesh:
    """A ``data x model`` mesh.  ``devices`` (a ``[data][model]`` grid of
    devices) places every position explicitly; otherwise as
    ``make_mesh``."""
    if devices is not None:
        grid = tuple(tuple(torch.device(x) for x in row) for row in devices)
        if len(grid) != data or any(len(row) != model for row in grid):
            raise ValueError(f"devices is not a {data}x{model} grid")
        return Mesh(grid)
    return make_mesh((data, model), ("data", "model"), device=device)


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


_MESH: contextvars.ContextVar[Mesh | None] = contextvars.ContextVar(
    "repro_torch_ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the ambient mesh for the block (the reference's
    ``jax.set_mesh``); the one before comes back on exit."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Mesh | None:
    """The mesh ``use_mesh`` installed, or None."""
    return _MESH.get()
