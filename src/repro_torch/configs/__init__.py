"""Architecture configs of the port: the dense GQA family (qwen3-1.7b,
gemma-7b, deepseek-67b, granite-8b)."""
from .registry import ArchSpec, all_archs, get  # noqa: F401
