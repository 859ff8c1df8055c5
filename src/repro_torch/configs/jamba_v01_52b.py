"""Jamba v0.1 52B [arXiv:2403.19887; hf] — hybrid Mamba+attention 1:7, MoE 16e top-2
every other layer.

Repeating 8-layer unit: attention at offset 4, MoE at odd offsets (period 2,
offset 1) — matches the HF config (attn_layer_period=8/offset=4,
expert_layer_period=2/offset=1). SSM blocks use the Mamba2/SSD formulation
(state 128) instead of Mamba1 (state 16), as the JAX package's copy does
[arXiv:2405.21060]: the port's copy of it, field for field.
"""
from repro_torch.configs.base import ArchConfig, LayerKind

_M, _A = "mamba", "attn"
_D, _E = "dense", "moe"
_PATTERN = tuple(
    LayerKind(_A if i == 4 else _M, _E if i % 2 == 1 else _D) for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    pattern=_PATTERN,
    n_experts=16,
    experts_per_token=2,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    norm="rmsnorm",
    act="swiglu",
    rope="none",  # Jamba uses no positional encoding in attn layers
    fsdp=True,
    optimizer="adamw",
    remat="dots",
)
