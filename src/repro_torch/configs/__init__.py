"""Architecture configs of the port (qwen3-1.7b so far)."""
from .registry import ArchSpec, all_archs, get  # noqa: F401
