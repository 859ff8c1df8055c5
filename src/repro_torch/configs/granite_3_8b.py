"""Granite-3 8B [hf:ibm-granite/granite-3.0-8b-base] — dense GQA kv=8."""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-8b-base",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    pattern=(LayerKind("attn", "dense"),),
    norm="rmsnorm",
    act="swiglu",
    optimizer="adamw",
    remat="dots",
)
