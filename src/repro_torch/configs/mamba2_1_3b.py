"""mamba2-1.3b  [ssm]
48L d_model=2048 (attention-free) d_ff=0 vocab=50280, ssm_state=128 —
SSD (state-space duality) blocks: chunked intra-chunk quadratic +
inter-chunk recurrent state carry.  O(1) decode state ⇒ long_500k applies.
[arXiv:2405.21060; unverified]
"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    period=("ssd",),
    mlp="swiglu",            # unused (d_ff=0): SSD block carries the MLP role
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  ngroups=1, chunk=256),
)


def reduced() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, vocab=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                      ngroups=1, chunk=32),
    )
