"""Mamba2-2.7B [arXiv:2405.21060; unverified] — attention-free SSD (state-space duality)."""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pattern=(LayerKind("mamba", "none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    norm="rmsnorm",
    rope="none",
    tie_embeddings=True,
    optimizer="adamw",
    remat="none",
)
