"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2, GQA kv=8.

The port's copy of the JAX package's config, field for field; the sharding
and optimizer fields describe the reference's TPU meshes and are kept only
so the two compare equal.
"""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    source="hf:xai-org/grok-1",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    pattern=(LayerKind("attn", "moe"),),
    n_experts=8,
    experts_per_token=2,
    norm="rmsnorm",
    act="swiglu",
    fsdp=True,
    optimizer="adafactor",
    remat="full",
)
