"""Carry the reference's weights into the port.

``params_from_numpy`` takes the value tree of the reference
``Model.init`` (``unzip(model.init(rng))[0]``) with every leaf converted
to a numpy array, and returns the port's parameter dict.  The
reference stacks the layers of each period position along a leading
``layers`` axis (``periods[pos][j]`` is layer ``j * len(period) + pos``)
followed by unrolled ``trailing`` layers; here they become one list in
layer order.  Leaves keep their layouts: ``wq`` (d,H,D), ``wo`` (H,D,d),
``embedding`` (V,d).
"""
from __future__ import annotations

import numpy as np
import torch

from .common import resolve_device


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # numpy has no bf16 of its own
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, *, device="cuda") -> dict:
    dev = resolve_device(device)
    if tree.get("prefix") or "encoder" in tree:
        raise NotImplementedError("dense-first-layer MoE and encoder-decoder "
                                  "weights are not ported yet (ROADMAP A6, A7)")
    periods = tree["periods"]
    n_scan = len(next(iter(_leaves(periods[0])))) if periods else 0
    layers = []
    for j in range(n_scan):
        for period in periods:
            layers.append(_map(period, lambda a: _tensor(a[j], dev)))
    for layer in tree["trailing"]:
        layers.append(_map(layer, lambda a: _tensor(a, dev)))
    return {"embed": _map(tree["embed"], lambda a: _tensor(a, dev)),
            "layers": layers,
            "final_norm": _tensor(tree["final_norm"], dev)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
