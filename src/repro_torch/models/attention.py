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

**Serving on a mesh** (``attn_prefill`` / ``attn_decode`` with ``tp``
and a ``KVLayout``): the same heads' split, and a cache block holding
every head at the rank's positions, or the rank's heads at every
position.  Without them the cache is the whole of it.

A layer's KV cache is a pair of (B, T, Hkv, D) tensors.  Where the
reference returns an updated copy, the chunk and decode paths here write
the new K/V **in place** into the caller's cache tensors (a slice of the
model's (layers, B, T, Hkv, D) cache) and return them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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
    take = kv_heads_read(cfg, tp, p["wq"].shape[1], p["wk"].device)
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in p:
            out[name] = take(tp.shared(p[name]), dim)
    return out


def kv_heads_read(cfg: ModelConfig, tp, hl: int, device):
    """``take(t, dim)``: of a tensor holding all the key/value heads along
    ``dim``, those that this rank's ``hl`` query heads read under the
    heads' ``Split`` ``tp``."""
    group = cfg.n_heads // cfg.n_kv_heads
    first = tp.rank * hl // group
    if hl % group == 0 or group % hl == 0:
        # a whole number of groups, or a part of one: plain GQA
        def take(t, dim):
            return t.narrow(dim, first, max(hl // group, 1))
    else:
        # groups cut across ranks: one key/value head a query head
        heads = torch.tensor([(tp.rank * hl + j) // group
                              for j in range(hl)], device=device)

        def take(t, dim):
            return t.index_select(dim, heads)
    return take


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


# ---------------------------------------------------------------------------
# serving: prefill and decode, on one device or on a mesh
# ---------------------------------------------------------------------------
class KVLayout(NamedTuple):
    """Where a rank's K/V cache block lies in the whole (B, T, Hkv, D)
    cache: ``seq_axes`` the mesh axes that split the positions (this
    rank's block is ``mesh.axis_index(seq_axes)``; empty: all
    positions), ``heads`` whether the model axis splits the key/value
    heads instead (this rank's, as its weights hold them), ``length``
    the whole cache's T."""
    mesh: object
    seq_axes: tuple
    heads: bool
    length: int

    @property
    def start(self) -> int:
        if not self.seq_axes:
            return 0
        return self.mesh.axis_index(self.seq_axes) * (
            self.length // self.mesh.axis_size(self.seq_axes))


def _whole(cache_k) -> KVLayout:
    """The layout of a cache that is the whole of it."""
    return KVLayout(None, (), False, cache_k.shape[1])


def _serve_qkv(cfg, p, x, positions, kind, tp, layout: KVLayout):
    """(q at this rank's query heads, k and v at the key/value heads those
    read, k and v at the heads the cache block holds).  The cache holds
    every head where the positions are split or nothing is: where the
    model axis splits ``wk`` they are all-gathered over it along the
    heads, where ``wk`` is whole every head is projected."""
    pl = _local(cfg, p, tp)
    q = _project_q(cfg, pl, x, positions, kind)
    if tp is None or p["wk"].shape[1] < cfg.n_kv_heads:
        k, v = _project_kv(cfg, pl, x, positions, kind)
        if tp is None or layout.heads:
            return q, k, v, k, v
        from ..distrib.collectives import all_gather_dim
        return (q, k, v) + tuple(all_gather_dim(t, tp.mesh, tp.axis, 2)
                                 for t in (k, v))
    k_all, v_all = _project_kv(cfg, p, x, positions, kind)
    take = kv_heads_read(cfg, tp, pl["wq"].shape[1], x.device)
    return q, take(k_all, 2), take(v_all, 2), k_all, v_all


def attn_prefill(cfg: ModelConfig, p: dict, x, cache_k, cache_v, *,
                 kind: str = "attn", prefix_len=None,
                 layout: Optional[KVLayout] = None, tp=None):
    """Self-attention over the whole prompt (causal, keys below
    ``prefix_len`` seen by every query); its K/V land at positions
    0..S-1 of the (B, T, Hkv, D) cache tensors.

    On a mesh: attention on this rank's heads (``tp``, the heads'
    ``Split``, or None where the model axis splits none), the prompt's
    K/V written into this rank's cache block (``layout``; None: the whole
    cache): every head at the block's positions (an all-gather of the
    heads over the model axis, then the block's slice), or this rank's
    heads at every position."""
    layout = layout or _whole(cache_k)
    S = x.shape[1]
    if tp is not None:
        x = tp.enter(x)
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v, k_c, v_c = _serve_qkv(cfg, p, x, positions, kind, tp, layout)
    lo = layout.start
    n = max(min(S - lo, cache_k.shape[1]), 0)
    cache_k[:, :n] = k_c[:, lo:lo + n]
    cache_v[:, :n] = v_c[:, lo:lo + n]
    out = _out(cfg, _local(cfg, p, tp), _attend(cfg, q, k, v, kind, 0,
                                                prefix_len=prefix_len))
    return out if tp is None else tp.leave(out)


def _write_at(cache_k, cache_v, k, v, pos, layout: KVLayout):
    """The new token's K/V (B,1,Hkv,D) at position ``pos`` of the whole
    cache, written where this rank's block holds it.  As in the
    reference, a scalar write clamps to the last position and a (B,)
    write past the cache is dropped (with no host sync: a row out of
    range rewrites its own old value)."""
    B, Tl = cache_k.shape[0], cache_k.shape[1]
    T, lo = layout.length, layout.start
    if not isinstance(pos, torch.Tensor) or pos.ndim == 0:
        t = min(max(int(pos), 0), T - 1) - lo
        if 0 <= t < Tl:
            cache_k[:, t] = k[:, 0]
            cache_v[:, t] = v[:, 0]
        return
    rows = torch.arange(B, device=k.device)
    t = pos.long() - lo
    keep = ((pos >= 0) & (pos < T) & (t >= 0) & (t < Tl))[:, None, None]
    t = t.clamp(0, Tl - 1)
    cache_k[rows, t] = torch.where(keep, k[:, 0].to(cache_k.dtype),
                                   cache_k[rows, t])
    cache_v[rows, t] = torch.where(keep, v[:, 0].to(cache_v.dtype),
                                   cache_v[rows, t])


def attn_decode(cfg: ModelConfig, p: dict, x, cache_k, cache_v, pos, *,
                kind: str = "attn", layout: Optional[KVLayout] = None,
                tp=None) -> torch.Tensor:
    """One-token decode. x: (B,1,d); ``pos`` is a scalar (lockstep) or a
    (B,) tensor (continuous batching); the new K/V are written as
    ``_write_at`` writes them.

    On a mesh (``tp`` and ``layout`` as ``attn_prefill``'s): where the
    positions are split (``layout.seq_axes``), the new token's queries
    (and K/V, where the model axis splits them) are all-gathered over
    the model axis to every head, the rank whose block holds ``pos``
    writes the K/V, and ``sp_decode_attention`` combines every block's
    partial (the attention kernel's, lse written); each rank keeps its
    own heads' output for the row-parallel ``wo``.  Where the heads are
    split, the rank attends to its own heads' cache, as training
    does."""
    from ..distrib.collectives import all_gather_dim, sp_decode_attention
    layout = layout or _whole(cache_k)
    if tp is not None:
        x = tp.enter(x)
    pos_t = torch.as_tensor(pos, device=x.device)
    positions = pos_t.reshape(1, 1) if pos_t.ndim == 0 else pos_t[:, None]
    q, k, v, k_c, v_c = _serve_qkv(cfg, p, x, positions, kind, tp, layout)
    _write_at(cache_k, cache_v, k_c, v_c, pos, layout)
    if layout.seq_axes:
        hl = q.shape[2]
        q_all = q if tp is None else all_gather_dim(q, tp.mesh, tp.axis, 2)
        o = sp_decode_attention(q_all, cache_k, cache_v, layout.mesh,
                                layout.seq_axes, cfg.attn_softcap, pos=pos,
                                window=cfg.window if kind == "local" else 0)
        if tp is not None:
            o = o.narrow(2, tp.rank * hl, hl)
    else:
        ck, cv = cache_k, cache_v
        if tp is not None and not layout.heads:
            take = kv_heads_read(cfg, tp, q.shape[2], x.device)
            ck, cv = take(ck, 2), take(cv, 2)
        o = _attend(cfg, q, ck, cv, kind, pos_t)
    out = _out(cfg, _local(cfg, p, tp), o)
    return out if tp is None else tp.leave(out)


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
