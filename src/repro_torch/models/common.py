"""Model substrate: device choice, seeded init, norms, RoPE, MLPs and
embeddings, as ``src/repro/models/common.py`` computes them.

Parameters are plain dicts of tensors.  The numerics follow the
reference: weights are kept in ``cfg.param_dtype`` and cast to
``cfg.compute_dtype`` where they are used; norms, RoPE and logits are
computed in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without a card
    raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init (seeded: the same seed gives the same weights on the same device)
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype,
               in_dim: Optional[int] = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, as the reference's ``dense_p``."""
    fan_in = in_dim if in_dim is not None else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(max(fan_in, 1))).to(dtype)


def zeros_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def ones_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# norms, RoPE
# ---------------------------------------------------------------------------
def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Split-half RoPE. x: (..., S, H, D); positions broadcastable to
    (..., S)."""
    D = x.shape[-1]
    freqs = torch.pow(theta, -torch.arange(0, D, 2, dtype=torch.float32,
                                           device=x.device) / D)
    angles = positions[..., None].float() * freqs             # (...,S,D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wi_gate"] = dense_init(gen, (d, f), dt)
        p["wi_up"] = dense_init(gen, (d, f), dt)
    else:
        p["wi"] = dense_init(gen, (d, f), dt)
    p["wo"] = dense_init(gen, (f, d), dt, in_dim=f)
    return p


def mlp(cfg: ModelConfig, p: dict, x):
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    if cfg.mlp == "swiglu":
        h = F.silu(xc @ p["wi_gate"].to(cdt)) * (xc @ p["wi_up"].to(cdt))
    elif cfg.mlp == "geglu":
        h = F.gelu(xc @ p["wi_gate"].to(cdt), approximate="tanh") \
            * (xc @ p["wi_up"].to(cdt))
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(xc @ p["wi"].to(cdt)))
    else:  # gelu
        h = F.gelu(xc @ p["wi"].to(cdt), approximate="tanh")
    return h @ p["wo"].to(cdt)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------
def embed_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg.param_dtype)
    p = {"embedding": dense_init(gen, (cfg.vocab, cfg.d_model), dt,
                                 in_dim=cfg.d_model)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dt)
    return p


def embed_tokens(cfg: ModelConfig, p: dict, tokens):
    cdt = dtype_of(cfg.compute_dtype)
    h = p["embedding"][tokens.long()].to(cdt)
    if cfg.embed_scale:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt,
                             device=h.device)
    return h


def unembed(cfg: ModelConfig, p: dict, h):
    """Logits in f32; the tied table is used transposed."""
    cdt = dtype_of(cfg.compute_dtype)
    w = p["embedding"].T if cfg.tie_embeddings else p["head"]
    logits = (h.to(cdt) @ w.to(cdt)).float()
    if cfg.logit_softcap > 0.0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits
