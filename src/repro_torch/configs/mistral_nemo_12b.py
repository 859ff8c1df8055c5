"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407] — GQA kv=8, head_dim=128, 128k ctx."""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,  # explicit: 5120/32=160 but Nemo uses 128
    d_ff=14336,
    vocab_size=131072,
    pattern=(LayerKind("attn", "dense"),),
    norm="rmsnorm",
    act="swiglu",
    rope_theta=1e6,
    max_seq_len=131072,
    optimizer="adamw",
    remat="dots",
)
