"""nemotron-4-340b  [dense]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000 — squared-ReLU
MLP, GQA. The largest assigned arch: fitting 16 GB/chip requires full
ZeRO-3 + TP sharding (see EXPERIMENTS.md dry-run memory analysis).
[arXiv:2402.16819; unverified]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    period=("attn",),
    mlp="relu2",
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=384, vocab=512,
    )
