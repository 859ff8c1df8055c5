"""Kimi K2 1T-A32B [arXiv:2501.kimi2; unverified] — MoE 384 experts top-8 + 1 shared,
first dense layer, GQA kv=8, head_dim 128.

The port's copy of the JAX package's config, field for field; the sharding
and optimizer fields describe the reference's TPU meshes and are kept only
so the two compare equal.
"""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    source="arXiv:2501.kimi2",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,  # 7168/64=112; K2 uses 128
    d_ff=2048,
    vocab_size=163840,
    pattern=(LayerKind("attn", "moe"),),
    first_k_dense=1,
    n_experts=384,
    experts_per_token=8,
    n_shared_experts=1,
    norm="rmsnorm",
    act="swiglu",
    fsdp=True,
    optimizer="adafactor",
    param_dtype="bfloat16",
    remat="full",
)
