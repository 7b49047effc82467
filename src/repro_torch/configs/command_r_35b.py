"""command-r-35b  [dense]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 — no biases,
parallel attention/FFN block (Cohere style), tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    period=("attn",),
    parallel_block=True,
    mlp="swiglu",
    tie_embeddings=True,
    rope_theta=8_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    )
