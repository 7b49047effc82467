"""granite-moe-3b-a800m  [moe]
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8.
Assignment lists "MoE 40e top-8" with a bracket note "32 experts top-8";
we take the primary spec (40 routed experts, top-8) — discrepancy recorded
in DESIGN.md §4. Fine-grained experts (d_ff=512 each).
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    period=("attn",),
    mlp="swiglu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8),
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab=512, moe=MoEConfig(num_experts=8, top_k=2),
    )
