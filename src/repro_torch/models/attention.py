"""GQA self-attention sub-layer: params, prefill, prefill chunk, decode.

Ports ``src/repro/models/attention.py`` (``attn_prefill``,
``attn_prefill_chunk``, ``attn_decode``) for the attention family: GQA,
RoPE (per-kind theta), sliding-window ("local") blocks, tanh logit
soft-capping, qk RMS-norm and QKV biases.  All three run on one kernel,
:func:`repro_torch.kernels.attention.attention`.

A layer's KV cache is a pair of (B, T, Hkv, D) tensors.  Where the
reference returns an updated copy, the chunk and decode paths here write
the new K/V **in place** into the caller's cache tensors (a slice of the
model's (layers, B, T, Hkv, D) cache) and return them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.attention import attention
from .common import (apply_rope, dense_init, dtype_of, ones_init, rms_norm,
                     zeros_init)


def attn_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dt = dtype_of(cfg.param_dtype)
    d, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, (d, H, D), dt),
        "wk": dense_init(gen, (d, Hkv, D), dt),
        "wv": dense_init(gen, (d, Hkv, D), dt),
        "wo": dense_init(gen, (H, D, d), dt, in_dim=H * D),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros_init(gen, (H, D), dt)
        p["bk"] = zeros_init(gen, (Hkv, D), dt)
        p["bv"] = zeros_init(gen, (Hkv, D), dt)
    if cfg.qk_norm:
        p["q_norm"] = ones_init(gen, (D,), dt)
        p["k_norm"] = ones_init(gen, (D,), dt)
    return p


def _theta(cfg: ModelConfig, kind: str) -> float:
    if kind == "global" and cfg.rope_theta_global > 0:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _proj(x, w, cdt):
    """x (B,S,d) @ w (d,H,D) → (B,S,H,D)."""
    d, H, D = w.shape
    return (x.to(cdt) @ w.to(cdt).reshape(d, H * D)).reshape(
        *x.shape[:2], H, D)


def _project(cfg, p, x, positions, kind):
    cdt = dtype_of(cfg.compute_dtype)
    q, k, v = _proj(x, p["wq"], cdt), _proj(x, p["wk"], cdt), \
        _proj(x, p["wv"], cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    theta = _theta(cfg, kind)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _out(cfg, p, o):
    cdt = dtype_of(cfg.compute_dtype)
    H, D, d = p["wo"].shape
    return o.to(cdt).reshape(*o.shape[:2], H * D) @ \
        p["wo"].to(cdt).reshape(H * D, d)


def _attend(cfg, q, k, v, kind, q_offset):
    return attention(q, k, v, causal=True,
                     window=cfg.window if kind == "local" else 0,
                     softcap=cfg.attn_softcap, q_offset=q_offset)


def attn_prefill(cfg: ModelConfig, p: dict, x, cache_k, cache_v, *,
                 kind: str = "attn"):
    """Self-attention over the whole prompt; its K/V land at positions
    0..S-1 of the (B, T, Hkv, D) cache tensors."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project(cfg, p, x, positions, kind)
    cache_k[:, :S] = k
    cache_v[:, :S] = v
    return _out(cfg, p, _attend(cfg, q, k, v, kind, 0))


def attn_prefill_chunk(cfg: ModelConfig, p: dict, x, cache_k, cache_v,
                       offset: int, *, kind: str = "attn"):
    """An S-token chunk at absolute positions ``offset..offset+S-1``
    against the full-length cache (earlier chunks or a resumed session's
    K/V below ``offset``).

    The chunk's K/V are written where the reference's
    ``lax.dynamic_update_slice`` writes them: it clamps the start to
    ``[0, T - S]``, so a padded last chunk that would cross ``T`` lands
    shifted down (the queries keep their unclamped positions)."""
    S, T = x.shape[1], cache_k.shape[1]
    positions = offset + torch.arange(S, device=x.device)[None, :]
    q, k, v = _project(cfg, p, x, positions, kind)
    start = min(max(int(offset), 0), T - S)
    cache_k[:, start:start + S] = k
    cache_v[:, start:start + S] = v
    return _out(cfg, p, _attend(cfg, q, cache_k, cache_v, kind, offset))


def attn_decode(cfg: ModelConfig, p: dict, x, cache_k, cache_v, pos, *,
                kind: str = "attn") -> Tuple[torch.Tensor, ...]:
    """One-token decode. x: (B,1,d); ``pos`` is a scalar (lockstep) or a
    (B,) tensor (continuous batching).  As in the reference, a scalar
    write clamps to the last position and a (B,) write past the cache is
    dropped."""
    B, T = x.shape[0], cache_k.shape[1]
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos.reshape(1, 1) if pos.ndim == 0 else pos[:, None]
    q, k, v = _project(cfg, p, x, positions, kind)
    if pos.ndim == 0:
        t = min(max(int(pos), 0), T - 1)
        cache_k[:, t] = k[:, 0]
        cache_v[:, t] = v[:, 0]
    else:
        # no host sync: rows out of range rewrite their own old value
        rows = torch.arange(B, device=x.device)
        t = pos.long().clamp(0, T - 1)
        keep = ((pos >= 0) & (pos < T))[:, None, None]
        cache_k[rows, t] = torch.where(keep, k[:, 0].to(cache_k.dtype),
                                       cache_k[rows, t])
        cache_v[rows, t] = torch.where(keep, v[:, 0].to(cache_v.dtype),
                                       cache_v[rows, t])
    return _out(cfg, p, _attend(cfg, q, cache_k, cache_v, kind, pos))
