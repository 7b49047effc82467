"""A training cell's rows, from its mix's parameters and the seed.

Every seed asks for the same work (``batch`` rows of ``seq_len`` tokens a
step); the seed draws the rows' token ids.
"""
from __future__ import annotations

import numpy as np

from .weights import seed_of


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed``: independent streams of
    one seed."""
    return np.random.default_rng([seed_of(seed), stream])


def train_batch(mix: dict, vocab: int, seed: int, step: int) -> dict:
    """Training step ``step``'s rows: ``batch`` rows of ``seq_len + 1``
    ids, each row its own draw from a Zipf law (ranks past the vocabulary
    wrapped round it) over a seeded permutation of the vocabulary (a
    text-like skew, every row different); tokens and next-token targets,
    int32."""
    B, S = int(mix["batch"]), int(mix["seq_len"])
    perm = rng(seed, 5).permutation(np.arange(1, vocab))
    r = np.random.default_rng([seed_of(seed), 6, step])
    ranks = (r.zipf(float(mix["zipf"]), size=(B, S + 1)) - 1) % (vocab - 1)
    toks = perm[ranks].astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
