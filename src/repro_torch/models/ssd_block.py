"""Mamba2 block (SSD, state-space duality), ported from
``src/repro/models/ssd_block.py``.

Projections: x → [z, xs, B, C, dt]; depthwise causal conv over
[xs, B, C]; the SSD scan (:func:`repro_torch.kernels.ssd.ssd`, the
hand-written kernel on the card); gated RMS-norm with z; output
projection.

Decode carries two states per layer: the SSD state (B,H,P,N) f32 and
the conv tail (B, cw-1, channels), both O(1) in sequence length.  The
conv is written as the reference writes it, ``cw`` shifted
multiply-adds, not ``F.conv1d``: a float32 convolution goes through
cuDNN in TF32 by default, and the port holds f32 to the reference.

Training runs ``ssd_block_apply`` with gradients on (``Model.loss_fn``):
the SSD's through ``SSDFunction`` (its backward kernels on the card);
the conv's backward is the same shifted slices and multiply-adds, summed
in a fixed order (no ``index_add_``), so a step repeats bitwise.

As in the reference, a prompt shorter than ``cw - 1`` tokens leaves a
one-row conv tail (``u[:, S-(cw-1):]`` with a negative start); the
engine writes that row to row 0 of the slot's tail and leaves the
others as they were.

**Tensor parallel** (the sharded training step, ``tp``: a
``distrib.tensor_parallel.Split`` of ``inner`` and ``ssm_heads``): this
rank computes its H/n heads.  ``wz``, ``wx`` and ``wdt`` are
column-parallel, ``dt_bias``, ``A_log``, ``D`` and ``norm`` hold its
share, ``wo`` is row-parallel and its partial output leaves through
``tp.leave``; the input enters through ``tp.enter``.  ``wB``, ``wC``,
``conv_w`` and ``conv_b`` are whole on every rank (every rank computes
B and C) and pass ``tp.shared``, their partial gradients summed: the
rank's conv runs on its slice of the xs channels and all the B/C
channels, columns cut out of the whole ``conv_w``.  The kernels get the
groups its heads read (``head_groups``).  The gated RMS norm runs over
the whole ``d_in``: each rank's sum of squares is summed over the axis
forward (``tp.sum``) and, since every rank's output reads every rank's
y, its gradient is summed backward (``tp.shared``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distrib.tensor_parallel import head_groups
from ..kernels.ssd import ssd, ssd_decode_step
from .common import dense_init, dtype_of, ones_init, rms_norm, zeros_init


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.ngroups * s.state_dim
    return d_in, H, s.head_dim, s.ngroups, s.state_dim, s.conv_width, conv_ch


def ssd_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Seeded random projections; ``A_log``, ``D`` and ``dt_bias`` take
    the reference's deterministic values (a decay spread over the heads
    is what keeps a long prompt's state from vanishing or blowing up)."""
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    d_in, H, Pd, G, N, cw, conv_ch = _dims(cfg)
    dev = gen.device
    return {
        "wz": dense_init(gen, (d, d_in), dt),
        "wx": dense_init(gen, (d, d_in), dt),
        "wB": dense_init(gen, (d, G * N), dt),
        "wC": dense_init(gen, (d, G * N), dt),
        "wdt": dense_init(gen, (d, H), dt),
        "dt_bias": zeros_init(gen, (H,), dt),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).to(dt),
        "D": ones_init(gen, (H,), dt),
        "conv_w": dense_init(gen, (cw, conv_ch), dt, in_dim=cw),
        "conv_b": zeros_init(gen, (conv_ch,), dt),
        "norm": ones_init(gen, (d_in,), dt),
        "wo": dense_init(gen, (d_in, d), dt),
    }


def ssd_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``ssd_params``' leaves, as the reference's
    ``ssd_params`` tags them."""
    return {"wz": ("embed", "inner"), "wx": ("embed", "inner"),
            "wB": ("embed", "state_proj"), "wC": ("embed", "state_proj"),
            "wdt": ("embed", "ssm_heads"), "dt_bias": ("ssm_heads",),
            "A_log": ("ssm_heads",), "D": ("ssm_heads",),
            "conv_w": ("conv", "conv_ch"), "conv_b": ("conv_ch",),
            "norm": ("inner",), "wo": ("inner", "embed")}


def _causal_conv(u, w, b):
    """Depthwise causal conv. u: (B,S,C); w: (cw,C); b: (C,)."""
    cw = w.shape[0]
    S = u.shape[1]
    pad = F.pad(u, (0, 0, cw - 1, 0))
    out = b[None, None]
    for i in range(cw):
        out = out + pad[:, i:i + S] * w[i][None, None]
    return out


def _conv_step(u_t, tail, w, b):
    """One conv step. u_t: (B,C); tail: (B,cw-1,C). Returns (y_t,
    new_tail)."""
    window = torch.cat([tail, u_t[:, None]], dim=1)             # (B,cw,C)
    y = (window * w[None]).sum(dim=1) + b     # promotes as jnp.einsum does
    return y, window[:, 1:]


def _split_conv_channels(cfg: ModelConfig, conv_out, d_in=None):
    """(xs, B, C) of the conv's output; ``d_in``: the xs channels it holds
    (default all)."""
    full, _, _, G, N, _, _ = _dims(cfg)
    d_in = d_in or full
    return (conv_out[..., :d_in], conv_out[..., d_in:d_in + G * N],
            conv_out[..., d_in + G * N:])


def _local(cfg: ModelConfig, p: dict, tp) -> dict:
    """``p`` as this rank's heads use it under ``tp``: the leaves whole on
    every rank passed through ``tp.shared``, and the conv's columns cut
    to this rank's xs channels and all the B/C channels."""
    d_in = _dims(cfg)[0]
    dl = p["wx"].shape[1]
    out = dict(p)
    for name in ("wB", "wC"):
        out[name] = tp.shared(p[name])
    for name in ("conv_w", "conv_b"):
        t = tp.shared(p[name])
        out[name] = torch.cat([t.narrow(-1, tp.rank * dl, dl),
                               t.narrow(-1, d_in, t.shape[-1] - d_in)],
                              dim=-1)
    return out


def _project(cfg: ModelConfig, p, x):
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    z = xc @ p["wz"].to(cdt)
    u = torch.cat([xc @ p["wx"].to(cdt), xc @ p["wB"].to(cdt),
                   xc @ p["wC"].to(cdt)], dim=-1)
    dt_raw = xc @ p["wdt"].to(cdt)
    return z, u, dt_raw


def _finish(cfg, p, y_heads, z, shape, tp=None):
    B, S = shape
    cdt = dtype_of(cfg.compute_dtype)
    y = y_heads.reshape(B, S, z.shape[-1])
    y = (rms_norm(y, p["norm"], cfg.norm_eps) if tp is None
         else _split_rms_norm(cfg, y, p["norm"], tp)) * \
        F.silu(z.float()).to(cdt)
    out = y.to(cdt) @ p["wo"].to(cdt)
    return out if tp is None else tp.leave(out)


def _split_rms_norm(cfg, y, weight, tp):
    """``rms_norm`` over all of ``d_in`` where y (B,S,d_in/n) and
    ``weight`` hold this rank's channels: the sum of squares summed over
    the axis, its gradient summed back."""
    yf = y.float()
    ss = tp.shared(tp.sum((yf * yf).sum(dim=-1, keepdim=True)))
    var = ss / (y.shape[-1] * tp.n)
    return (yf * torch.rsqrt(var + cfg.norm_eps) * weight.float()).to(
        y.dtype)


def _decay_inputs(p, dt_raw):
    """(dt, A) in f32: dt = softplus(dt_raw + dt_bias), A = -exp(A_log)."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def ssd_block_apply(cfg: ModelConfig, p: dict, x, *,
                    want_cache: bool = False, tp=None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Prefill. x: (B,S,d). Returns (out, {"h", "conv"} or None).
    ``tp``: the heads' ``Split`` (see the module docstring); a cache then
    holds this rank's heads and conv channels."""
    d_in, H, Pd, G, N, cw, conv_ch = _dims(cfg)
    if tp is not None:
        x = tp.enter(x)
        p = _local(cfg, p, tp)
    B, S, d = x.shape
    z, u, dt_raw = _project(cfg, p, x)
    conv_out = F.silu(_causal_conv(u, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = _split_conv_channels(cfg, conv_out, z.shape[-1])
    Bm, Cm = Bm.reshape(B, S, G, N), Cm.reshape(B, S, G, N)
    if tp is not None:
        # the groups this rank's heads read
        g0, n_g = head_groups(H, G, tp.n, tp.rank)
        Bm, Cm = Bm[:, :, g0:g0 + n_g], Cm[:, :, g0:g0 + n_g]
    dt, A = _decay_inputs(p, dt_raw)
    y, h_fin = ssd(xs.reshape(B, S, -1, Pd), dt, A, Bm, Cm, p["D"], None,
                   chunk=cfg.ssm.chunk)
    out = _finish(cfg, p, y, z, (B, S), tp)
    cache = None
    if want_cache:
        # a negative start (S < cw - 1) keeps one row, as the reference
        cache = {"h": h_fin.float(),
                 "conv": u[:, S - (cw - 1):, :].to(x.dtype)}
    return out, cache


def ssd_block_decode(cfg: ModelConfig, p: dict, x, cache: dict, tp=None
                     ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: (B,1,d); cache {"h", "conv"}.  Returns (out,
    new {"h", "conv"}).  ``tp``: the heads' ``Split``; ``h`` then holds
    this rank's heads and ``conv`` the whole tail (``whole_conv_tail``)."""
    B = x.shape[0]
    d_in, H, Pd, G, N, cw, conv_ch = _dims(cfg)
    tail = cache["conv"]
    if tp is not None:
        x = tp.enter(x)
        p = _local(cfg, p, tp)
        dl = p["wx"].shape[1]
        tail = torch.cat([tail.narrow(-1, tp.rank * dl, dl),
                          tail.narrow(-1, d_in, conv_ch - d_in)], dim=-1)
    z, u, dt_raw = _project(cfg, p, x)
    conv_y, new_tail = _conv_step(u[:, 0], tail.to(u.dtype),
                                  p["conv_w"], p["conv_b"])
    xs, Bm, Cm = _split_conv_channels(cfg, F.silu(conv_y), z.shape[-1])
    Bm, Cm = Bm.reshape(B, G, N), Cm.reshape(B, G, N)
    if tp is not None:
        g0, n_g = head_groups(H, G, tp.n, tp.rank)
        Bm, Cm = Bm[:, g0:g0 + n_g], Cm[:, g0:g0 + n_g]
    dt, A = _decay_inputs(p, dt_raw[:, 0])
    y_t, h_new = ssd_decode_step(cache["h"], xs.reshape(B, -1, Pd), dt, A,
                                 Bm, Cm, p["D"])
    out = _finish(cfg, p, y_t[:, None], z, (B, 1), tp)
    if tp is not None:
        new_tail = whole_conv_tail(cfg, new_tail, tp)
    return out, {"h": h_new.float(),
                 "conv": new_tail.to(cache["conv"].dtype)}


def whole_conv_tail(cfg: ModelConfig, tail, tp):
    """A rank's conv tail (B, cw-1, d_in/n + 2GN), its xs channels and all
    the B/C channels, made whole (B, cw-1, conv_ch): the xs channels
    all-gathered over the heads' axis."""
    from ..distrib.collectives import all_gather_dim
    dl = tail.shape[-1] - (_dims(cfg)[-1] - _dims(cfg)[0])
    xs = all_gather_dim(tail[..., :dl].contiguous(), tp.mesh, tp.axis,
                        tail.ndim - 1)
    return torch.cat([xs, tail[..., dl:]], dim=-1)


def ssd_cache_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                   device="cpu") -> dict:
    """Zeroed decode state: h (B,H,P,N) f32 whatever ``dtype`` is, conv
    tail (B, cw-1, channels) in ``dtype``."""
    d_in, H, Pd, G, N, cw, conv_ch = _dims(cfg)
    return {"h": torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cw - 1, conv_ch), dtype=dtype,
                                device=device)}
