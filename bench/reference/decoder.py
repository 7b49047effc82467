"""The plain reference of a dense decoder configuration (the family
``decoder``): its training loss and gradients in float32 with TF32 off.

It reads only a configuration file's keys and the benchmark's stacked
weights, and imports nothing of the program.  It follows the
architecture the configuration file states:

* token embedding; pre-norm blocks: x + attention(norm1(x)), then
  + MLP(norm2(.)), each norm an RMS norm at ``rms_norm_eps``;
* self-attention: q, k and v projections, each with its bias where
  ``attention_bias``, split-half RoPE at ``rope_theta`` over positions
  0..S-1, causal, GQA (query head h reads key/value head h // (H / Hkv)),
  softmax scale 1/sqrt(head_dim), and the output projection;
* a SwiGLU MLP of ``intermediate_size``;
* a final RMS norm and the head (the embedding's transpose when
  ``tie_word_embeddings``).

The loss is the mean cross entropy over every token plus ``lm_z`` times
the mean squared log-sum-exp of the logits.  ``loss_grads`` takes it one
sequence at a time, each layer recomputed in the backward
(``torch.utils.checkpoint``), and sums the sequences' gradients: the
same loss and gradients as the whole batch at once, in a fraction of the
memory.  Under ``quant`` every linear layer runs in float8
(``common.linear``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import linear, rms_norm, rope, swiglu


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


class Model:
    """The reference model of a configuration file ``cfg`` over stacked
    weights ``w`` (any dtype; read in f32)."""

    HEAD_BLOCK = 16          # query heads a block of the attention

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        self.cfg, self.w, self.quant = cfg, w, quant
        self.lay = self.layout(cfg)
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])

    layout = Layout

    def attention(self, h, i, pos):
        """Causal self-attention of layer ``i`` over one sequence's rows
        ``h`` (S, d) at positions ``pos``."""
        lay, w, q8 = self.lay, self.w, self.quant
        d, H, Hkv, D = lay.d, lay.H, lay.Hkv, lay.D
        q = linear(h, w["wq"][i].reshape(d, H * D), q8).view(-1, H, D)
        k = linear(h, w["wk"][i].reshape(d, Hkv * D), q8).view(-1, Hkv, D)
        v = linear(h, w["wv"][i].reshape(d, Hkv * D), q8).view(-1, Hkv, D)
        if lay.bias:
            q, k, v = q + w["bq"][i], k + w["bk"][i], v + w["bv"][i]
        q, k = rope(q, pos, self.theta), rope(k, pos, self.theta)
        g = H // Hkv
        S = h.shape[0]
        mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        o = []
        for h0 in range(0, H, self.HEAD_BLOCK):
            hs = range(h0, min(h0 + self.HEAD_BLOCK, H))
            qb = q[:, hs.start:hs.stop].transpose(0, 1)          # (b,S,D)
            kv = torch.tensor([j // g for j in hs], device=h.device)
            kb = k.index_select(1, kv).transpose(0, 1)
            vb = v.index_select(1, kv).transpose(0, 1)
            s = (qb @ kb.transpose(1, 2)) * (1.0 / math.sqrt(D))
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
            o.append((p @ vb).transpose(0, 1))                   # (S,b,D)
        o = torch.cat(o, dim=1).reshape(-1, H * D)
        return linear(o, w["wo"][i].reshape(H * D, d), q8)

    def block(self, x, i, pos):
        w = self.w
        x = x + self.attention(rms_norm(x, w["norm1"][i], self.eps), i, pos)
        return x + swiglu(rms_norm(x, w["norm2"][i], self.eps),
                          w["mlp_wi_gate"][i], w["mlp_wi_up"][i],
                          w["mlp_wo"][i], self.quant)

    def head(self, h):
        w = self.w
        hw = w["embedding"].T if self.lay.tied else w["head"]
        return linear(rms_norm(h, w["final_norm"], self.eps), hw, self.quant)

    def seq_loss(self, h, targets, lm_z, n):
        """One sequence's part of the loss from its last hidden rows
        ``h`` (S, d): its cross entropy and ``lm_z`` times its squared
        log-sum-exp, summed over its rows, over ``n`` rows in all."""
        logits = self.head(h)
        lse = torch.logsumexp(logits, -1)
        tgt = logits.gather(1, targets.reshape(-1, 1).long())[:, 0]
        return ((lse - tgt).sum() + lm_z * torch.square(lse).sum()) / n

    def loss_grads(self, tokens: torch.Tensor, targets: torch.Tensor,
                   lm_z: float):
        """The training loss of ``tokens`` / ``targets`` (B, S) and its
        gradient for every weight, a sequence at a time."""
        B, S = tokens.shape
        names = list(self.w)
        grads = {n: torch.zeros_like(self.w[n]) for n in names}
        pos = torch.arange(S, device=tokens.device)
        total = 0.0
        for b in range(B):
            x = self.w["embedding"][tokens[b].long()].float()
            for i in range(self.lay.L):
                x = checkpoint(self.block, x, i, pos, use_reentrant=False)
            part = self.seq_loss(x, targets[b], lm_z, B * S)
            got = torch.autograd.grad(part, [self.w[n] for n in names],
                                      allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            total += float(part.detach())
            del part, got, x
        return total, grads
