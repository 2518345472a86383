"""Model families of the port: the dense GQA transformer so far."""
from .transformer import LMConfig, TransformerLM  # noqa: F401
