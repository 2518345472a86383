"""Model families of the port: the dense, MoE and MLA transformers so far."""
from .transformer import LMConfig, TransformerLM  # noqa: F401
