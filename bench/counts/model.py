"""A decoder's useful operations, from its configuration file's keys.

Useful means what the model's mathematics needs, at 2 operations a
multiply-add: each linear layer once a token (a bias's adds are not
counted); attention's Q·Kᵀ and P·V over the (query, key) pairs a causal
mask leaves visible; the head once a token.  Recomputation and padding
are not counted.
"""
from __future__ import annotations


def body_params(cfg: dict) -> float:
    """The parameters a token multiplies in the layers (not the head):
    the attention projections and the SwiGLU MLP."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    Hkv, L = cfg["num_key_value_heads"], cfg["num_hidden_layers"]
    D = cfg.get("head_dim") or d // H
    attn = d * (H + 2 * Hkv) * D + H * D * d
    return float(L * (attn + 3 * d * cfg["intermediate_size"]))


def head_params(cfg: dict) -> float:
    return float(cfg["hidden_size"] * cfg["vocab_size"])


def attn_pair_flops(cfg: dict) -> float:
    """Operations of one visible (query, key) pair over every layer's
    heads (Q·Kᵀ and P·V)."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    D = cfg.get("head_dim") or d // H
    return 4.0 * H * D * cfg["num_hidden_layers"]


def pairs(n: int, offset: int) -> int:
    """Visible pairs of n queries at positions offset..offset+n-1."""
    return n * offset + n * (n + 1) // 2


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """A training step: 6 operations a parameter a token (forward and
    backward) over the layers and the head, and 3x the forward's
    attention pairs."""
    tokens = batch * seq
    return (6 * tokens * (body_params(cfg) + head_params(cfg))
            + 3 * attn_pair_flops(cfg) * batch * pairs(seq, 0))
