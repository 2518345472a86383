"""Model families of the port: the dense, MoE and MLA transformers, the
Mamba2 SSM, the Mamba2 / shared-attention hybrid, the encoder-decoder and
the VLM (every family the reference serves)."""
from .encdec import EncDecConfig, EncDecLM  # noqa: F401
from .hybrid import HybridConfig, HybridLM  # noqa: F401
from .multimodal import VLM, VLMConfig  # noqa: F401
from .ssm_lm import SSMLM, SSMLMConfig  # noqa: F401
from .transformer import LMConfig, TransformerLM  # noqa: F401
