"""Ported architectures, with the reference's full and smoke configs
(``repro/configs/archs.py``)."""
from __future__ import annotations

from repro_torch.models.transformer import LMConfig, TransformerLM

from .registry import ArchSpec, register

# --- qwen3-1.7b [dense, qk_norm] ---------------------------------------------

register(ArchSpec(
    arch_id="qwen3-1.7b",
    family="dense",
    make_model=lambda: TransformerLM(LMConfig(
        name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=6144, vocab=151936, head_dim=128, qk_norm=True,
        rope_theta=1e6)),
    make_smoke=lambda: TransformerLM(LMConfig(
        name="smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, qk_norm=True)),
    n_params=2.03e9, n_active_params=2.03e9,
))
