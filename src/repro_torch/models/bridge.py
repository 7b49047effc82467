"""Carry the reference's weights into the port.

``params_from_numpy`` takes the value tree of the reference
``Model.init`` (``unzip(model.init(rng))[0]``) with every leaf converted
to a numpy array (or a tensor, as a checkpoint restore returns them),
and returns the port's parameter dict.  The reference unrolls special
first layers (``prefix``: deepseek's dense layer 0), stacks the layers
of each period position along a leading ``layers`` axis
(``periods[pos][j]`` is layer ``prefix + j * len(period) + pos``) and
unrolls the ``trailing`` layers; here they become one list in layer
order.  An encoder-decoder's ``encoder.stack`` (stacked over
``n_enc_layers``) becomes ``encoder.layers``, a list in layer order,
beside ``encoder.final_norm``; its decoder layers keep their ``cross``
and ``cross_norm`` subtrees, and ``embed`` its ``frontend_proj``.
Leaves keep their layouts: ``wq`` (d,H,D), ``wo`` (H,D,d),
``embedding`` (V,d); MoE layers carry ``moe`` subtrees (``router``
(d,E), ``wi_gate``/``wi_up`` (E,d,f), ``wo`` (E,f,d), ``shared``).
"""
from __future__ import annotations

import numpy as np
import torch

from .common import resolve_device


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
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
    periods = tree["periods"]
    layers = [_map(layer, lambda a: _tensor(a, dev))
              for layer in tree.get("prefix", ())]
    for j in range(_depth(periods[0]) if periods else 0):
        for period in periods:
            layers.append(_unstack(period, j, dev))
    for layer in tree["trailing"]:
        layers.append(_map(layer, lambda a: _tensor(a, dev)))
    out = {"embed": _map(tree["embed"], lambda a: _tensor(a, dev)),
           "layers": layers,
           "final_norm": _tensor(tree["final_norm"], dev)}
    if "encoder" in tree:
        stack = tree["encoder"]["stack"]
        out["encoder"] = {
            "layers": [_unstack(stack, j, dev)
                       for j in range(_depth(stack))],
            "final_norm": _tensor(tree["encoder"]["final_norm"], dev)}
    return out


def _depth(stacked: dict) -> int:
    """The length of a stacked subtree's leading (layers) axis."""
    return len(next(iter(_leaves(stacked))))


def _unstack(stacked: dict, j: int, dev) -> dict:
    """Layer ``j`` of a subtree stacked over layers."""
    return _map(stacked, lambda a: _tensor(a[j], dev))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
