"""The reference's ten architectures, with its full and smoke configs
(``repro/configs/archs.py``): the MoE family, deepseek-v2-lite-16b (MLA)
and llama4-scout-17b-a16e; the dense GQA family, qwen3-1.7b, gemma-7b,
deepseek-67b and granite-8b; the VLM pixtral-12b, the encoder-decoder
whisper-large-v3, the hybrid zamba2-7b and the SSM mamba2-1.3b.  The smoke
configs train with the reference's ``loss_chunk=32``; ``microbatch`` holds
the reference's per-shape microbatch counts (``MB``, ``MB_BIG``)."""
from __future__ import annotations

from repro_torch.models.encdec import EncDecConfig, EncDecLM
from repro_torch.models.hybrid import HybridConfig, HybridLM
from repro_torch.models.multimodal import VLM, VLMConfig
from repro_torch.models.ssm_lm import SSMLM, SSMLMConfig
from repro_torch.models.transformer import LMConfig, TransformerLM

from .registry import ALL_SHAPES, QUADRATIC_SHAPES, ArchSpec, register

MB = {"train_4k": 8, "prefill_32k": 4, "decode_32k": 1, "long_500k": 1}
MB_BIG = {"train_4k": 16, "prefill_32k": 8, "decode_32k": 1, "long_500k": 1}

# --- deepseek-v2-lite-16b [moe, MLA] [arXiv:2405.04434] ---------------------

register(ArchSpec(
    arch_id="deepseek-v2-lite-16b",
    family="moe",
    make_model=lambda: TransformerLM(LMConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=10944, vocab=102400, attention="mla",
        mla_kv_rank=512, mla_qk_nope=128, mla_qk_rope=64, mla_v_dim=128,
        n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
        first_dense_layers=1)),
    make_smoke=lambda: TransformerLM(LMConfig(
        name="smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=160, vocab=256, attention="mla", mla_kv_rank=32, mla_qk_nope=16,
        mla_qk_rope=8, mla_v_dim=16, n_experts=8, top_k=2, moe_d_ff=64,
        n_shared_experts=1, first_dense_layers=1, loss_chunk=32)),
    n_params=15.8e9, n_active_params=2.7e9,
    microbatch=MB,
    notes="MLA kv_lora=512; 64 routed + 2 shared, top-6 (V2-Lite)",
))


# --- llama4-scout-17b-a16e [moe] ---------------------------------------------

register(ArchSpec(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    make_model=lambda: TransformerLM(LMConfig(
        name="llama4-scout-17b-a16e", n_layers=48, d_model=5120, n_heads=40,
        n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
        n_experts=16, top_k=1, moe_d_ff=8192, n_shared_experts=1)),
    make_smoke=lambda: TransformerLM(LMConfig(
        name="smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=8, n_experts=4, top_k=1, moe_d_ff=128,
        n_shared_experts=1, loss_chunk=32)),
    n_params=107e9, n_active_params=17e9,
    microbatch=MB_BIG,
    notes="16 routed top-1 + 1 shared expert; iRoPE/NoPE simplified to "
          "full-attention RoPE",
))


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
        d_ff=128, vocab=256, head_dim=16, qk_norm=True, loss_chunk=32)),
    n_params=2.03e9, n_active_params=2.03e9,
    microbatch=MB,
))


# --- gemma-7b [dense, GeGLU, head_dim 256] [arXiv:2403.08295] ----------------

register(ArchSpec(
    arch_id="gemma-7b",
    family="dense",
    make_model=lambda: TransformerLM(LMConfig(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
        n_kv_heads=16, d_ff=24576, vocab=256000, head_dim=256,
        activation="gelu", embed_scale=True, zero_centered_norm=True)),
    make_smoke=lambda: TransformerLM(LMConfig(
        name="smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=512, head_dim=32, activation="gelu",
        embed_scale=True, zero_centered_norm=True, loss_chunk=32)),
    n_params=9.3e9, n_active_params=9.3e9,
    microbatch=MB,
))


# --- deepseek-67b [dense, 95L] [arXiv:2401.02954] ----------------------------

register(ArchSpec(
    arch_id="deepseek-67b",
    family="dense",
    make_model=lambda: TransformerLM(LMConfig(
        name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=22016, vocab=102400, head_dim=128)),
    make_smoke=lambda: TransformerLM(LMConfig(
        name="smoke", n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab=256, head_dim=8, loss_chunk=32)),
    n_params=67.4e9, n_active_params=67.4e9,
    microbatch=MB_BIG,
))


# --- granite-8b [dense, code] [arXiv:2405.04324] -----------------------------

register(ArchSpec(
    arch_id="granite-8b",
    family="dense",
    make_model=lambda: TransformerLM(LMConfig(
        name="granite-8b", n_layers=36, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=49152, head_dim=128)),
    make_smoke=lambda: TransformerLM(LMConfig(
        name="smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=160, vocab=256, head_dim=8, loss_chunk=32)),
    n_params=8.3e9, n_active_params=8.3e9,
    microbatch=MB,
))


# --- pixtral-12b [vlm] --------------------------------------------------------

register(ArchSpec(
    arch_id="pixtral-12b",
    family="vlm",
    make_model=lambda: VLM(VLMConfig(lm=LMConfig(
        name="pixtral-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
        rope_theta=1e9), n_patches=256, d_vit=1024)),
    make_smoke=lambda: VLM(VLMConfig(lm=LMConfig(
        name="smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, head_dim=16, loss_chunk=32),
        n_patches=8, d_vit=32)),
    shapes=QUADRATIC_SHAPES,
    n_params=12.3e9, n_active_params=12.3e9,
    microbatch=MB_BIG,
    notes="ViT frontend stubbed: the caller gives [B, 256, 1024] patch "
          "embeddings; projector + text backbone implemented",
))


# --- whisper-large-v3 [audio, enc-dec] [arXiv:2212.04356] --------------------

register(ArchSpec(
    arch_id="whisper-large-v3",
    family="encdec",
    make_model=lambda: EncDecLM(EncDecConfig(
        name="whisper-large-v3", n_enc_layers=32, n_dec_layers=32,
        d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
        n_frames=1500)),
    make_smoke=lambda: EncDecLM(EncDecConfig(
        name="smoke", n_enc_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, n_frames=16, loss_chunk=32)),
    shapes=QUADRATIC_SHAPES,
    n_params=1.6e9, n_active_params=1.6e9,
    microbatch=MB,
    notes="conv/mel frontend stubbed: the caller gives [B, 1500, 1280] "
          "frame embeddings; enc-dec (not encoder-only) so decode runs",
))


# --- zamba2-7b [hybrid] [arXiv:2411.15242] ------------------------------------

register(ArchSpec(
    arch_id="zamba2-7b",
    family="hybrid",
    make_model=lambda: HybridLM(HybridConfig(
        name="zamba2-7b", n_blocks=81, shared_every=6, d_model=3584,
        n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000, d_state=64)),
    make_smoke=lambda: HybridLM(HybridConfig(
        name="smoke", n_blocks=12, shared_every=4, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, d_state=16, ssm_head_dim=16,
        lora_rank=8, ssd_chunk=16, loss_chunk=32)),
    shapes=ALL_SHAPES,
    n_params=5.9e9, n_active_params=5.9e9,
    microbatch=MB,
    notes="Mamba2 backbone + shared attn block every 6th position with "
          "per-occurrence FFN LoRA; sub-quadratic decode -> runs long_500k",
))


# --- mamba2-1.3b [ssm, SSD] [arXiv:2405.21060] --------------------------------

register(ArchSpec(
    arch_id="mamba2-1.3b",
    family="ssm",
    make_model=lambda: SSMLM(SSMLMConfig(
        name="mamba2-1.3b", n_layers=48, d_model=2048, d_state=128,
        vocab=50280)),
    make_smoke=lambda: SSMLM(SSMLMConfig(
        name="smoke", n_layers=3, d_model=64, d_state=16, vocab=256,
        head_dim=16, ssd_chunk=16, loss_chunk=32)),
    shapes=ALL_SHAPES,
    n_params=1.44e9, n_active_params=1.44e9,
    microbatch=MB,
    notes="attention-free SSD; O(1) decode state -> runs long_500k",
))
