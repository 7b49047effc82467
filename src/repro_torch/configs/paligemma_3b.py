"""paligemma-3b  [vlm]
18L d_model=2048 8H (GQA kv=1, i.e. MQA) d_ff=16384 vocab=257216 —
gemma-2b text backbone; the SigLIP vision tower is a STUB
(``input_specs()`` provides precomputed patch embeddings).  Prefix-LM
attention: image+prefix tokens attend bidirectionally, suffix is causal.
[arXiv:2407.07726; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    period=("attn",),
    prefix_lm=True,
    embed_scale=True,
    mlp="geglu",
    tie_embeddings=True,
    frontend="vision_patches",
    frontend_seq=256,        # 224px/14 -> 16x16 patches
    frontend_dim=1152,       # SigLIP-So400m width
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, frontend_seq=16, frontend_dim=32,
    )
