"""deepseek-moe-16b  [moe]
28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6,
2 shared + 64 routed, fine-grained segmentation; layer 0 is a dense FFN
(width 10944) per the paper.  [arXiv:2401.06066; hf]
"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    period=("attn",),
    mlp="swiglu",
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  first_layer_dense=True, first_dense_ff=10944),
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab=512,
        moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=1,
                      first_layer_dense=True, first_dense_ff=128),
    )
