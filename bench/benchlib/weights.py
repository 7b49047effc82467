"""Seeded weights for a decoder configuration, made on the device in a few
large calls, and the port's parameter tree over them.

The weights are one tensor per kind of leaf, stacked over the layers
(``stacked``): the attention projections and their biases, the
feed-forward layers, the norms.  Each is drawn with one ``torch.randn``
call on a ``torch.Generator`` on the device, in the dtype it is trained
in, and scaled in place: a projection by 1/sqrt(fan-in), a bias by
``BIAS_STD``; the norms' scales are ones.
The same seed, device and dtype give the same bits, so the reference can
draw them again (``stacked``) instead of reading anything the program
holds.

``port_tree`` gives the port's ``Model`` its parameter tree as views of
these tensors (``repro_torch.models.transformer``'s layout).
"""
from __future__ import annotations

from typing import Dict, List

import torch

SEED_MASK = (1 << 63) - 1
# a bias at half the spread of its projection's output (about 1 over
# normed rows), so that the bias path carries weight in the comparison
BIAS_STD = 0.5


def seed_of(seed: int) -> int:
    """A run's seed as a generator's: any whole number, folded into 63
    bits."""
    return int(seed) & SEED_MASK


class Layout:
    """A decoder configuration file's sizes (Hugging Face names)."""

    def __init__(self, cfg: dict):
        self.L = cfg["num_hidden_layers"]
        self.d = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.Hkv = cfg["num_key_value_heads"]
        self.D = cfg.get("head_dim") or self.d // self.H
        self.V = cfg["vocab_size"]
        self.F = cfg["intermediate_size"]
        self.tied = bool(cfg.get("tie_word_embeddings"))
        self.bias = bool(cfg.get("attention_bias"))

    def shapes(self) -> List[tuple]:
        """(name, shape, scale) of each stacked tensor, in draw order; a
        scale of 0 marks a norm's scale (ones)."""
        d, H, Hkv, D, V, L, F = (self.d, self.H, self.Hkv, self.D, self.V,
                                 self.L, self.F)
        out = [("embedding", (V, d), d ** -0.5)]
        if not self.tied:
            out.append(("head", (d, V), d ** -0.5))
        out += [("wq", (L, d, H, D), d ** -0.5),
                ("wk", (L, d, Hkv, D), d ** -0.5),
                ("wv", (L, d, Hkv, D), d ** -0.5),
                ("wo", (L, H, D, d), (H * D) ** -0.5)]
        if self.bias:
            out += [("bq", (L, H, D), BIAS_STD), ("bk", (L, Hkv, D), BIAS_STD),
                    ("bv", (L, Hkv, D), BIAS_STD)]
        out += [("mlp_wi_gate", (L, d, F), d ** -0.5),
                ("mlp_wi_up", (L, d, F), d ** -0.5),
                ("mlp_wo", (L, F, d), F ** -0.5),
                ("norm1", (L, d), 0), ("norm2", (L, d), 0),
                ("final_norm", (d,), 0)]
        return out


def stacked(cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The seeded weights, one tensor per kind of leaf (``Layout.shapes``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed))
    out = {}
    for name, shape, scale in Layout(cfg).shapes():
        if scale == 0:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen, dtype=dtype,
                                    device=device).mul_(scale)
    return out


def port_tree(cfg: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree, each leaf a view of ``w``."""
    lay = Layout(cfg)
    embed = {"embedding": w["embedding"]}
    if not lay.tied:
        embed["head"] = w["head"]
    attn = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if lay.bias
                                       else ())
    layers = [{"norm1": w["norm1"][i], "norm2": w["norm2"][i],
               "attn": {n: w[n][i] for n in attn},
               "mlp": {n: w[f"mlp_{n}"][i]
                       for n in ("wi_gate", "wi_up", "wo")}}
              for i in range(lay.L)]
    return {"embed": embed, "layers": layers, "final_norm": w["final_norm"]}
