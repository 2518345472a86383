"""Architecture configs of the port: the reference's ten archs, in its
dense, MoE, VLM, encoder-decoder, hybrid and SSM families."""
from .registry import ArchSpec, all_archs, get  # noqa: F401
