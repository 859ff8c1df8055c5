"""Qwen2-VL 72B [arXiv:2409.12191; hf] — VLM transformer BACKBONE only.

The vision frontend (dynamic-resolution ViT) is a stub: the caller gives
precomputed patch/text embeddings [B, S, d_model] and 3D M-RoPE position ids
[3, B, S] (temporal/height/width rotary sections 16/24/24 over half of
head_dim 128).
"""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    pattern=(LayerKind("attn", "dense"),),
    norm="rmsnorm",
    act="swiglu",
    rope="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    embed_inputs=False,  # frontend stub supplies embeddings
    fsdp=True,
    optimizer="adamw",
    remat="full",
)
