"""Architecture configs of the port: the reference's ten archs, in its
dense, MoE, VLM, encoder-decoder, hybrid and SSM families, and the dry
run's shape grid."""
from .registry import (ALL_SHAPES, SHAPES, ArchSpec, ShapeCell,  # noqa: F401
                       all_archs, get, grid)
