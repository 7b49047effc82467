"""What every plain reference shares: float32 with TF32 off, the linear
layers' precision (and its float8 control), RMS norm, RoPE, SwiGLU, and
AdamW as a configuration's optimizer states it.  Plain PyTorch; it
imports nothing of the program.

``quant`` (``fp8``) rounds a linear layer's input rows and weight
columns to float8 e4m3 with their own scale before the product: the
control that a lower precision fails the comparison.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


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
