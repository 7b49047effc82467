"""gemma3-12b  [dense]
48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144 — 5 local
(sliding-window 1024) : 1 global layer pattern, 128k context, qk-norm,
sqrt(d) embed scaling, separate RoPE base for global layers.
long_500k applies: decode cost is O(window) on 5/6 of layers; global
layers use the full KV — see DESIGN.md §4 note.
[hf:google/gemma-3-1b-pt; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    period=("local", "local", "local", "local", "local", "global"),
    window=1024,
    qk_norm=True,
    embed_scale=True,
    mlp="geglu",
    tie_embeddings=True,
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, window=32,
    )
