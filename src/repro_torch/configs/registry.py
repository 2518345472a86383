"""Architecture registry (port of ``repro/configs/registry.py``): each
``ArchSpec`` builds its full-size model and a reduced smoke model of the
same family, and gives meta-tensor stand-ins for every input of a shape
cell (``input_specs``, ``cache_specs``), which the dry run
(``launch/dryrun.py``) traces against; nothing is allocated."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}

#: The dry-run grid's shape names: long_500k applies only to the
#: sub-quadratic-decode families (ssm, hybrid).
ALL_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
QUADRATIC_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    make_model: Callable[[], Any]
    make_smoke: Callable[[], Any]
    shapes: tuple[str, ...] = QUADRATIC_SHAPES
    # approximate parameter counts (total, active)
    n_params: float = 0.0
    n_active_params: float = 0.0
    # microbatches per shape cell (configs/archs.MB, MB_BIG)
    microbatch: dict[str, int] = dataclasses.field(default_factory=dict)
    notes: str = ""

    def input_specs(self, shape, model=None) -> dict:
        """Meta tensors for every model input of the shape cell (a name in
        ``SHAPES`` or a ``ShapeCell``): int32 tokens (and labels), the
        VLM's bf16 ``patches`` [B, 256, 1024] with S - 256 text tokens,
        the encoder-decoder's bf16 ``frames`` [B, 1500, 1280]; at decode
        tokens [B, 1] and a 0-d int32 ``cur_len``.  ``model``: size the
        frontends' inputs for it (a smoke model) instead of the full one."""
        cell = SHAPES[shape] if isinstance(shape, str) else shape
        b, s = cell.global_batch, cell.seq_len
        c = getattr(model, "cfg", None)

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        extras = {}
        text_len = s
        if self.family == "vlm":
            n_patch, d_vit = (256, 1024) if c is None else (c.n_patches,
                                                            c.d_vit)
            extras["patches"] = meta((b, n_patch, d_vit), torch.bfloat16)
            text_len = s - n_patch
        if self.family == "encdec":
            frames = (1500, 1280) if c is None else (c.n_frames, c.d_model)
            extras["frames"] = meta((b,) + frames, torch.bfloat16)
        if cell.kind == "train":
            return {"tokens": meta((b, text_len)),
                    "labels": meta((b, text_len)), **extras}
        if cell.kind == "prefill":
            return {"tokens": meta((b, text_len)), **extras}
        # decode: one new token against a cache of seq_len
        return {"tokens": meta((b, 1)), "cur_len": meta(())}

    def cache_specs(self, shape):
        """The decode cache of the shape cell as meta tensors."""
        from repro_torch.models.params import abstract_params
        cell = SHAPES[shape] if isinstance(shape, str) else shape
        return abstract_params(self.make_model().cache_defs(
            cell.global_batch, cell.seq_len))


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


def grid() -> list[tuple[str, str]]:
    """Every (arch, shape) cell of the dry run, archs sorted."""
    from . import archs  # noqa: F401
    return [(a, s) for a in sorted(_REGISTRY) for s in _REGISTRY[a].shapes]
