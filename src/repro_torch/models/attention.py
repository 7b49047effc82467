"""GQA attention sub-layer: params, training, prefill, prefill chunk,
decode, and the cross attention of an encoder-decoder.

Ports ``src/repro/models/attention.py`` (``attn_apply``, ``attn_prefill``,
``attn_prefill_chunk``, ``attn_decode``, ``cross_attn_apply``,
``cross_kv``): GQA, RoPE (per-kind theta), sliding-window ("local")
blocks, tanh logit soft-capping, qk RMS-norm, QKV biases, prefix-LM masks
(``prefix_len``: keys below it are seen by every query) and non-causal
self-attention (an encoder).  Cross attention projects its queries
without RoPE and attends without a mask to K/V projected (without RoPE)
from the encoder's output once per layer.  All of them run on one
kernel, :func:`repro_torch.kernels.attention.attention`.

**Tensor parallel** (training on a mesh, ``tp``: a
``distrib.tensor_parallel.Split`` of the heads): ``wq``/``wk``/``wv`` and
their biases hold this rank's heads (column-parallel) and ``wo`` its
rows (row-parallel); the input enters through ``tp.enter`` and the
partial outputs are summed by ``tp.leave``, and the kernel runs on the
rank's H/n query heads and its key/value heads.  Where the model axis
does not divide the key/value heads (MQA), they are whole on every rank:
each rank projects only those its query heads read, and those leaves and
the qk norms (applied to the rank's heads only) pass ``tp.shared``,
which sums their partial gradients over the axis.  Under sequence
parallelism ``tp.enter`` puts the sequence together first, so RoPE's
positions, the window and the causal mask see the whole of it.

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


def attn_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``attn_params``' leaves, as the reference's
    ``attn_params`` tags them."""
    p = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if cfg.qkv_bias:
        p["bq"] = ("heads", "head_dim")
        p["bk"] = ("kv_heads", "head_dim")
        p["bv"] = ("kv_heads", "head_dim")
    if cfg.qk_norm:
        p["q_norm"] = ("head_dim",)
        p["k_norm"] = ("head_dim",)
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


def _local(cfg: ModelConfig, p: dict, tp) -> dict:
    """``p`` as this rank's query heads use it under the heads' ``Split``
    ``tp`` (None: ``p`` itself): whole key/value leaves cut to the heads
    those query heads read, and every leaf whole on every rank passed
    through ``tp.shared``."""
    if tp is None:
        return p
    out = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            out[name] = tp.shared(p[name])
    if p["wk"].shape[1] < cfg.n_kv_heads:          # split like the queries
        return out
    hl, group = p["wq"].shape[1], cfg.n_heads // cfg.n_kv_heads
    first = tp.rank * hl // group
    if hl % group == 0 or group % hl == 0:
        # a whole number of groups, or a part of one: plain GQA
        def take(t, dim):
            return t.narrow(dim, first, max(hl // group, 1))
    else:
        # groups cut across ranks: one key/value head a query head
        heads = torch.tensor([(tp.rank * hl + j) // group
                              for j in range(hl)], device=p["wk"].device)

        def take(t, dim):
            return t.index_select(dim, heads)
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in p:
            out[name] = take(tp.shared(p[name]), dim)
    return out


def _project_q(cfg, p, x, positions, kind, use_rope=True):
    cdt = dtype_of(cfg.compute_dtype)
    q = _proj(x, p["wq"], cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return apply_rope(q, positions, _theta(cfg, kind)) if use_rope else q


def _project_kv(cfg, p, x, positions, kind, use_rope=True):
    cdt = dtype_of(cfg.compute_dtype)
    k, v = _proj(x, p["wk"], cdt), _proj(x, p["wv"], cdt)
    if "bk" in p:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        k = apply_rope(k, positions, _theta(cfg, kind))
    return k, v


def _project(cfg, p, x, positions, kind):
    return (_project_q(cfg, p, x, positions, kind),
            *_project_kv(cfg, p, x, positions, kind))


def _out(cfg, p, o):
    cdt = dtype_of(cfg.compute_dtype)
    H, D, d = p["wo"].shape
    return o.to(cdt).reshape(*o.shape[:2], H * D) @ \
        p["wo"].to(cdt).reshape(H * D, d)


def _attend(cfg, q, k, v, kind, q_offset, causal=True, prefix_len=None):
    return attention(q, k, v, causal=causal,
                     window=cfg.window if kind == "local" else 0,
                     softcap=cfg.attn_softcap, q_offset=q_offset,
                     prefix_len=prefix_len)


def attn_train(cfg: ModelConfig, p: dict, x, *, kind: str = "attn",
               causal: bool = True, prefix_len=None, tp=None):
    """Full-sequence self-attention for training and for an encoder
    (``causal=False``), as the reference's ``attn_apply``: positions
    0..S-1, no cache.  ``attention`` carries the gradient
    (``AttentionFunction``).  ``tp``: the heads' ``Split`` (see the
    module docstring), or None."""
    p = _local(cfg, p, tp)
    if tp is not None:
        x = tp.enter(x)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project(cfg, p, x, positions, kind)
    out = _out(cfg, p, _attend(cfg, q, k, v, kind, 0, causal, prefix_len))
    return out if tp is None else tp.leave(out)


def attn_prefill(cfg: ModelConfig, p: dict, x, cache_k, cache_v, *,
                 kind: str = "attn", prefix_len=None):
    """Self-attention over the whole prompt (causal, keys below
    ``prefix_len`` seen by every query); its K/V land at positions
    0..S-1 of the (B, T, Hkv, D) cache tensors."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project(cfg, p, x, positions, kind)
    cache_k[:, :S] = k
    cache_v[:, :S] = v
    return _out(cfg, p, _attend(cfg, q, k, v, kind, 0,
                                prefix_len=prefix_len))


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


# ---------------------------------------------------------------------------
# cross attention (encoder-decoder)
# ---------------------------------------------------------------------------
def cross_attn(cfg: ModelConfig, p: dict, x, mem_k, mem_v, tp=None):
    """Decoder cross attention: queries from x (B,S,d) without RoPE,
    against the memory's K/V (B,F,Hkv,D), no mask.  Under ``tp`` the
    K/V are this rank's (``cross_kv`` with the same ``tp``)."""
    p = _local(cfg, p, tp)
    if tp is not None:
        x = tp.enter(x)
    q = _project_q(cfg, p, x, None, "attn", use_rope=False)
    out = _out(cfg, p, _attend(cfg, q, mem_k, mem_v, "attn", 0,
                               causal=False))
    return out if tp is None else tp.leave(out)


def cross_kv(cfg: ModelConfig, p: dict, memory, tp=None):
    """The cross attention's K/V (B,F,Hkv,D) from the encoder's output
    (B,F,d), without RoPE: computed once per layer and kept in the
    cache for decode.  Under ``tp``, this rank's key/value heads."""
    p = _local(cfg, p, tp)
    if tp is not None:
        memory = tp.shared(memory)
    return _project_kv(cfg, p, memory, None, "attn", use_rope=False)
