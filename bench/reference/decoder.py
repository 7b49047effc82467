"""The plain reference of a decoder configuration: its training loss and
gradients, and AdamW, in float32 with TF32 off.

It reads only a configuration file's keys and the benchmark's stacked
weights (``benchlib.weights``), and imports nothing of the program.  It
follows the architecture the configuration file states:

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
memory.

``quant`` (``fp8``) rounds every linear layer's input rows and weight
columns to float8 e4m3 with their own scale before the product: the
control that a lower precision fails the comparison.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchlib.weights import Layout


class f32_exact:
    """TF32 off for float32 products while inside."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                    torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.old
        torch.set_float32_matmul_precision(prec)


# ---------------------------------------------------------------------------
# precision of the linear layers
# ---------------------------------------------------------------------------
FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude at the format's largest value), back in f32.
    The rounding passes the gradient straight through."""
    with torch.no_grad():
        s = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) \
            / FP8_MAX
        q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    """x (N, i) @ w (i, o) in f32; under ``quant`` "fp8" both rounded
    first (x by row, w by output column)."""
    if quant not in (None, "fp8"):
        raise ValueError(f"quant {quant!r}")
    w = w.float()
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rms_norm(x, weight, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * weight.float()


def rope(x, pos, theta):
    """Split-half RoPE: x (N, h, D), pos (N,) positions."""
    D = x.shape[-1]
    freqs = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                    device=x.device) / D)
    ang = pos.float()[:, None] * freqs[None]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def swiglu(x, gate, up, down, quant):
    return linear(F.silu(linear(x, gate, quant)) * linear(x, up, quant),
                  down, quant)


class Decoder:
    """The reference model of a configuration file ``cfg`` over stacked
    weights ``w`` (any dtype; read in f32)."""

    HEAD_BLOCK = 16          # query heads a block of the attention

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        self.cfg, self.w, self.quant = cfg, w, quant
        self.lay = Layout(cfg)
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])

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
            logits = self.head(x)
            lse = torch.logsumexp(logits, -1)
            tgt = logits.gather(1, targets[b].reshape(-1, 1).long())[:, 0]
            part = ((lse - tgt).sum() + lm_z * torch.square(lse).sum()) \
                / (B * S)
            got = torch.autograd.grad(part, [self.w[n] for n in names],
                                      allow_unused=True)
            for n, g in zip(names, got):
                if g is not None:
                    grads[n] += g
            total += float(part.detach())
            del logits, lse, tgt, part, got, x
        return total, grads


# ---------------------------------------------------------------------------
# AdamW, as the configuration's optimizer states it
# ---------------------------------------------------------------------------
def schedule(opt: dict, step: int) -> float:
    """Linear warm-up over ``warmup`` steps, then a cosine to
    ``min_lr_frac`` of ``lr`` at ``decay_steps``."""
    warm = min(step / max(opt["warmup"], 1), 1.0)
    prog = min(max((step - opt["warmup"])
                   / max(opt["decay_steps"] - opt["warmup"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) \
        * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


class AdamW:
    """AdamW over named tensors: the gradient clipped to ``grad_clip`` by
    its global norm, bias-corrected moments, and weight decay times
    ``decays(name)``: 0 or 1 for the whole tensor, or a tensor of 0s and
    1s that broadcasts against it (which layers of a stack decay)."""

    def __init__(self, opt: dict, params: Dict[str, torch.Tensor],
                 decays: Callable[[str], object]):
        self.opt, self.params, self.decays = opt, params, decays
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update in place; returns the clipped gradients, as the
        update used them."""
        o = self.opt
        self.count += 1
        lr = schedule(o, self.count)
        gn = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clip = min(o["grad_clip"] / max(float(gn), 1e-9), 1.0)
        c1, c2 = 1 - o["b1"] ** self.count, 1 - o["b2"] ** self.count
        used = {}
        for n, p in self.params.items():
            g = grads[n] * clip
            used[n] = g
            self.m[n].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[n].mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            step = (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + o["eps"])
            step = step + o["weight_decay"] * self.decays(n) * p
            p.sub_(lr * step)
        return used
