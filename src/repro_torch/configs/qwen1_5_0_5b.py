"""qwen1.5-0.5b  [dense]
24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936 — QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    period=("attn",),
    qkv_bias=True,
    mlp="swiglu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    )
