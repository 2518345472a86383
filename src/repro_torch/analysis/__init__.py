"""Static analysis of the port's kernel launches (port of
``repro/analysis``): the contract checker recomputes the CUDA launch plans
from shapes alone and holds them to the invariants the kernels check
(``csrc/*.cu`` ``plan_ok``).

    python -m repro_torch.analysis [--sms N] [--doc-table | --write-docs]

The reference's AST lint (``repro/analysis/lint.py``) is not ported: it
already lints ``src/repro_torch/``.  This ``__init__`` stays light: the
kernel wrappers import ``errors``, and ``contracts`` imports the wrappers.
"""
from __future__ import annotations

from .errors import ContractViolation  # noqa: F401

__all__ = ["ContractViolation", "contracts"]


def __getattr__(name: str):
    if name == "contracts":
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
