"""OLMo-1B [arXiv:2402.00838; hf] — dense, non-parametric LayerNorm, MHA (kv=16=H)."""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    pattern=(LayerKind("attn", "dense"),),
    norm="nonparametric_ln",
    act="swiglu",
    tie_embeddings=True,
    optimizer="adamw",
    remat="none",
)
