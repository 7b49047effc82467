"""Seeded weights for a configuration, made on the device in a few large
calls, and the port's parameter tree over them.

The configuration's family (``families.of``) says which tensors there
are, in which order they are drawn and how they are scaled
(``shapes``): each is drawn with one ``torch.randn`` call on a
``torch.Generator`` on the device, in the dtype it is trained in, and
scaled in place; a scale of 0 gives ones.  The same seed, device and
dtype give the same bits, so the reference can draw them again
(``stacked``) instead of reading anything the program holds.

``port_tree`` gives the port's ``Model`` its parameter tree as views of
these tensors, as the family lays it out.
"""
from __future__ import annotations

from typing import Dict

import torch

import families

SEED_MASK = (1 << 63) - 1


def seed_of(seed: int) -> int:
    """A run's seed as a generator's: any whole number, folded into 63
    bits."""
    return int(seed) & SEED_MASK


def stacked(cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The seeded weights, one tensor per kind of leaf, in the family's
    draw order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed))
    out = {}
    for name, shape, scale in families.of(cfg).shapes(cfg):
        if scale == 0:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device).mul_(scale)
    return out


def port_tree(cfg: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree, each leaf a view of ``w``."""
    return families.of(cfg).port_tree(cfg, w)
