"""seamless-m4t-large-v2  [audio]
24L d_model=1024 16H (GQA kv=16) d_ff=8192 vocab=256206 — encoder-decoder
text backbone; the speech/audio frontend is a STUB (``input_specs()``
provides precomputed frame embeddings; see DESIGN.md).
[arXiv:2308.11596; hf]
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,          # decoder depth
    n_enc_layers=24,      # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    period=("attn",),
    mlp="gelu",
    qkv_bias=True,
    frontend="audio_frames",
    frontend_seq=512,      # precomputed speech frames per example
    frontend_dim=160,      # fbank-ish raw feature dim before projection
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, frontend_seq=16, frontend_dim=20,
    )
