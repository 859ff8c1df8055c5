"""SeamlessM4T-medium [arXiv:2308.11596; hf] — encoder-decoder, multimodal.

Backbone only: the speech frontend is a stub; the caller gives precomputed
frame embeddings [B, S_src, d_model] to the encoder. The decoder
embeds target tokens (vocab 256206) and cross-attends to encoder output.
12 encoder + 12 decoder layers, d_model 1024, 16 heads (kv=16 => MHA),
d_ff 4096, GELU FFN, parametric LayerNorm. RoPE stands in for the original
learned positions, as in the reference's config.
"""
from repro_torch.configs.base import ArchConfig, LayerKind

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    pattern=(LayerKind("attn", "dense"),),
    norm="layernorm",
    act="gelu",
    encoder_decoder=True,
    n_encoder_layers=12,
    embed_inputs=False,  # encoder side consumes frame embeddings
    optimizer="adamw",
    remat="none",
)
