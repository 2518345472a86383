"""Architecture registry (port of ``repro/configs/registry.py``): each
``ArchSpec`` builds its full-size model and a reduced smoke model of the
same family."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    make_model: Callable[[], Any]
    make_smoke: Callable[[], Any]
    # approximate parameter counts (total, active)
    n_params: float = 0.0
    n_active_params: float = 0.0
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    from . import archs  # noqa: F401  (populate on first use)
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"architecture {arch_id!r} is not ported yet; "
                       f"ported: {all_archs()}") from None


def all_archs() -> list[str]:
    from . import archs  # noqa: F401
    return sorted(_REGISTRY)
