"""recurrentgemma-9b  [hybrid]
38L d_model=4096 16H (GQA kv=1, i.e. MQA) d_ff=12288 vocab=256000 —
RG-LRU (Griffin) recurrent blocks + local attention in a 2:1 pattern
(rec, rec, local-attn), window 2048.  O(1) recurrent state + bounded
window ⇒ long_500k applies.  38 = 12 full periods + 2 trailing recurrent
layers.  [arXiv:2402.19427; unverified]
"""
from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    period=("rglru", "rglru", "local"),
    window=2048,
    embed_scale=True,
    mlp="geglu",
    tie_embeddings=True,
    logit_softcap=30.0,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, window=32, rglru=RGLRUConfig(lru_width=64),
    )
