"""RG-LRU recurrent block (Griffin / recurrentgemma), ported from
``src/repro/models/rglru_block.py``.

A gate branch (linear + GeLU) times a recurrent branch (linear → causal
conv → RG-LRU, :func:`repro_torch.kernels.rglru.rglru`, the hand-written
kernels on the card, forward and backward), projected out.  The recurrence gates (r, i) are
per-channel affine functions of the conv output, as in the reference.

Decode state: the LRU hidden (B,W) f32 and the conv tail (B,cw-1,W).  A
prompt shorter than ``cw - 1`` tokens leaves a one-row conv tail, as in
the reference (see ``ssd_block``).

**Tensor parallel** (the sharded training step, ``tp``: a
``distrib.tensor_parallel.Split`` of ``lru``): every leaf is on ``lru``,
so the block is channel-parallel end to end.  ``w_gate`` and ``w_x`` are
column-parallel, the conv, the gates and ``log_lambda`` hold this rank's
W/n channels (the scan kernels run at W/n), ``w_out`` is row-parallel;
the input enters through ``tp.enter`` and the partial output leaves
through ``tp.leave``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rglru import rglru, rglru_decode_step
from .common import dense_init, dtype_of, ones_init, zeros_init
from .ssd_block import _causal_conv, _conv_step


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_params(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Seeded random projections; ``log_lambda`` takes the reference's
    deterministic spread, so that a = exp(-8·softplus(Λ)·σ(r)) spans
    about (0.9, 0.999)."""
    dt = dtype_of(cfg.param_dtype)
    d, w = cfg.d_model, _width(cfg)
    cw = cfg.rglru.conv_width
    return {
        "w_gate": dense_init(gen, (d, w), dt),
        "w_x": dense_init(gen, (d, w), dt),
        "conv_w": dense_init(gen, (cw, w), dt, in_dim=cw),
        "conv_b": zeros_init(gen, (w,), dt),
        "a_gate_w": ones_init(gen, (w,), dt),
        "a_gate_b": zeros_init(gen, (w,), dt),
        "i_gate_w": ones_init(gen, (w,), dt),
        "i_gate_b": zeros_init(gen, (w,), dt),
        "log_lambda": torch.linspace(-4.3, -1.5, w,
                                     device=gen.device).to(dt),
        "w_out": dense_init(gen, (w, d), dt),
    }


def rglru_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``rglru_params``' leaves, as the reference's
    ``rglru_params`` tags them."""
    return {"w_gate": ("embed", "lru"), "w_x": ("embed", "lru"),
            "conv_w": ("conv", "lru"), "conv_b": ("lru",),
            "a_gate_w": ("lru",), "a_gate_b": ("lru",),
            "i_gate_w": ("lru",), "i_gate_b": ("lru",),
            "log_lambda": ("lru",), "w_out": ("lru", "embed")}


def _branches(cfg, p, x):
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    gate = F.gelu(xc @ p["w_gate"].to(cdt), approximate="tanh")
    return gate, xc @ p["w_x"].to(cdt)


def _gates(p, u):
    uf = u.float()
    return (uf * p["a_gate_w"].float() + p["a_gate_b"].float(),
            uf * p["i_gate_w"].float() + p["i_gate_b"].float())


def rglru_block_apply(cfg: ModelConfig, p: dict, x, *,
                      want_cache: bool = False, tp=None
                      ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Train / prefill. x: (B,S,d). Returns (out, {"h", "conv"} or None).

    Training runs the same algebra with gradients on: the conv promotes
    the branch to f32 against the f32 conv weights (its backward sums the
    ``cw`` shifted slices of one padded tensor in a fixed order), so the
    recurrence, ``RGLRUFunction``, runs in f32 at any compute dtype (and
    with 16-bit weights, ``param_gather``, the branch is widened for
    it).
    ``tp``: the ``lru`` channels' ``Split`` (see the module docstring);
    a cache then holds this rank's channels."""
    if tp is not None:
        x = tp.enter(x)
    B, S, d = x.shape
    cw = cfg.rglru.conv_width
    gate, conv_in = _branches(cfg, p, x)
    u = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    r_pre, i_pre = _gates(p, u)
    h, h_fin = rglru(u.float(), r_pre, i_pre, p["log_lambda"], None)
    cdt = dtype_of(cfg.compute_dtype)
    out = (h.to(cdt) * gate) @ p["w_out"].to(cdt)
    if tp is not None:
        out = tp.leave(out)
    cache = None
    if want_cache:
        # a negative start (S < cw - 1) keeps one row, as the reference
        cache = {"h": h_fin.float(),
                 "conv": conv_in[:, S - (cw - 1):, :].to(x.dtype)}
    return out, cache


def rglru_block_decode(cfg: ModelConfig, p: dict, x, cache: dict, tp=None
                       ) -> Tuple[torch.Tensor, dict]:
    """One-token decode. x: (B,1,d); cache {"h", "conv"}.  ``tp``: the
    ``lru`` channels' ``Split``; the cache then holds this rank's
    channels."""
    if tp is not None:
        x = tp.enter(x)
    gate, u = _branches(cfg, p, x)
    conv_y, new_tail = _conv_step(u[:, 0], cache["conv"].to(u.dtype),
                                  p["conv_w"], p["conv_b"])
    r_pre, i_pre = _gates(p, conv_y)
    _, h_new = rglru_decode_step(cache["h"], conv_y, r_pre, i_pre,
                                 p["log_lambda"])
    cdt = dtype_of(cfg.compute_dtype)
    out = (h_new.to(cdt)[:, None] * gate) @ p["w_out"].to(cdt)
    if tp is not None:
        out = tp.leave(out)
    return out, {"h": h_new.float(),
                 "conv": new_tail.to(cache["conv"].dtype)}


def rglru_cache_spec(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device="cpu") -> dict:
    """Zeroed decode state: h (B,W) f32 whatever ``dtype`` is, conv tail
    (B, cw-1, W) in ``dtype``."""
    w = _width(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                                dtype=dtype, device=device)}
