"""A model's useful operations in a training step, from its
configuration file.

Useful means what the model's mathematics needs, at 2 operations a
multiply-add: each linear layer a token multiplies, once (a bias's adds
are not counted; of a mixture of experts, the experts the token is sent
to); attention's Q·Kᵀ and P·V over the (query, key) pairs a causal mask
leaves visible; the head once a token.  Recomputation and padding are
not counted.  The configuration's family (``families.of``) counts the
parameters a token multiplies and a visible pair's operations.
"""
from __future__ import annotations

import families


def pairs(n: int, offset: int) -> int:
    """Visible pairs of n queries at positions offset..offset+n-1."""
    return n * offset + n * (n + 1) // 2


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """A training step: 6 operations a parameter a token (forward and
    backward), the head included, and 3x the forward's attention
    pairs."""
    fam = families.of(cfg)
    tokens = batch * seq
    return (6 * tokens * fam.multiplied_params(cfg)
            + 3 * fam.attn_pair_flops(cfg) * batch * pairs(seq, 0))
