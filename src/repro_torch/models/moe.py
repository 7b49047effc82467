"""Mixture-of-Experts layer, ported from ``src/repro/models/moe.py`` for
one device (the reference's ``spmd=None`` path).

Per call: router logits (padded experts masked to -1e30), top-k routing
through the router kernel's wrapper, then capacity dispatch of the T·k
assignments into an (E, C, d) buffer in (token, choice) order — by a
stable sort over experts (``dispatch="sort"``) or a running count per
expert (``"cumsum"``) — the experts' SwiGLU FFNs as batched products, and
each token's k weighted expert outputs gathered back and summed.  Assignments past an
expert's capacity C = ceil(T·k/E · cf) are dropped and contribute zero;
serving runs dropless (C = T: an expert can receive each token at most
once).  The expert products stay ``torch.bmm``, as the reference leaves
its einsums to XLA.

The expert-parallel ``shard_map`` path (``MoESpmd``) is not ported yet
(ROADMAP A10).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.moe_router import router_topk
from .common import dense_init, dtype_of, mlp, mlp_params

NEG_INF = -1e30


def padded_experts(cfg: ModelConfig, n_shards: int) -> int:
    e = cfg.moe.num_experts
    return int(math.ceil(e / n_shards) * n_shards)


def moe_params(cfg: ModelConfig, gen: torch.Generator,
               e_pad: Optional[int] = None) -> dict:
    dt = dtype_of(cfg.param_dtype)
    d, f = cfg.d_model, cfg.d_ff
    E = e_pad or cfg.moe.num_experts
    p = {"router": dense_init(gen, (d, E), dt),
         "wi_gate": dense_init(gen, (E, d, f), dt, in_dim=d),
         "wi_up": dense_init(gen, (E, d, f), dt, in_dim=d),
         "wo": dense_init(gen, (E, f, d), dt, in_dim=f)}
    if cfg.moe.num_shared_experts:
        p["shared"] = mlp_params(cfg, gen,
                                 d_ff=cfg.moe.num_shared_experts * cfg.d_ff)
    return p


def _expert_ffn(cfg: ModelConfig, p: dict, buf):
    """buf: (E, C, d) -> (E, C, d), gated experts.  Each weight is cast
    to the compute dtype where it is used, and the copy is dropped as
    soon as its product is taken."""
    cdt = dtype_of(cfg.compute_dtype)
    x = buf.to(cdt)
    gate = torch.bmm(x, p["wi_gate"].to(cdt))
    up = torch.bmm(x, p["wi_up"].to(cdt))
    if cfg.mlp == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:                                   # swiglu, and the default
        h = F.silu(gate) * up
    del gate, up
    return torch.bmm(h, p["wo"].to(cdt))


def _moe_local(cfg: ModelConfig, params: dict, x2d, *, e_pad: int,
               capacity_factor: float, dropless: bool = False):
    """Dispatch + expert FFN over x2d: (T, d).  Returns y (T, d) and the
    aux sums (load per expert, prob per expert, router z, T)."""
    T, d = x2d.shape
    E_real, k = cfg.moe.num_experts, cfg.moe.top_k
    cdt = dtype_of(cfg.compute_dtype)
    dev = x2d.device

    logits = (x2d.to(cdt) @ params["router"].to(cdt)).float()   # (T, E)
    if e_pad > E_real:
        pad_mask = torch.arange(e_pad, device=dev) >= E_real
        logits = torch.where(pad_mask[None], NEG_INF, logits)
    w, idx, probs = router_topk(logits, k)                      # (T, k)

    load_sum = F.one_hot(idx.long(), e_pad).float().sum(1).sum(0)  # (E,)
    prob_sum = probs.sum(0)
    z_sum = torch.square(torch.logsumexp(logits, dim=-1)).sum()

    if dropless:
        C = T
    else:
        C = max(int(math.ceil(T * k / max(E_real, 1) * capacity_factor)), 1)

    flat_e = idx.reshape(-1).long()              # (T*k,), (t, j) order
    if cfg.moe.dispatch == "cumsum":
        # position in expert = earlier assignments to the same expert
        ohf = (flat_e[:, None] == torch.arange(e_pad, device=dev)[None, :]
               ).float()                                        # (T*k, E)
        prior = torch.cumsum(ohf, dim=0) - ohf
        pos_in_e = (prior * ohf).sum(1).long()
        flat_pos = torch.arange(T * k, device=dev)
        se = flat_e
    else:
        flat_pos = torch.argsort(flat_e, stable=True)
        se = flat_e[flat_pos]
        seg_start = torch.searchsorted(se, torch.arange(e_pad, device=dev))
        pos_in_e = torch.arange(T * k, device=dev) - seg_start[se]
    # over-capacity assignments are dropped: the reference scatters them
    # out of bounds with mode="drop"; torch indexing needs them removed
    keep = pos_in_e < C
    ke, kc, kp = se[keep], pos_in_e[keep], flat_pos[keep]

    buf = torch.zeros((e_pad, C, d), dtype=x2d.dtype, device=dev)
    buf.index_put_((ke, kc), x2d[kp // k])
    out_buf = _expert_ffn(cfg, params, buf)                     # (E, C, d)
    del buf

    # each token's k weighted expert outputs, summed in choice order (no
    # atomics: the same inputs give the same sum on the card)
    vals = torch.zeros((T * k, d), dtype=out_buf.dtype, device=dev)
    vals[kp] = out_buf[ke, kc] * w.reshape(-1)[kp][:, None].to(vals.dtype)
    y = vals.view(T, k, d).sum(1)
    return y, (load_sum, prob_sum, z_sum, float(T))


def _aux_from_stats(cfg: ModelConfig, load_sum, prob_sum, z_sum, t_total):
    E_real, k = cfg.moe.num_experts, cfg.moe.top_k
    frac_load = (load_sum / max(t_total * k, 1.0))[:E_real]
    frac_prob = (prob_sum / max(t_total, 1.0))[:E_real]
    lb = E_real * torch.sum(frac_load * frac_prob)
    z = z_sum / max(t_total, 1.0)
    return {"moe_lb": lb * cfg.moe.aux_coef,
            "moe_z": z * cfg.moe.router_z_coef}


def moe_apply(cfg: ModelConfig, params: dict, x, *,
              capacity_factor: Optional[float] = None,
              dropless: bool = False) -> Tuple[torch.Tensor, dict]:
    """MoE FFN over x: (B, S, d).  Returns (y, aux_losses)."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    cf = capacity_factor if capacity_factor is not None \
        else cfg.moe.capacity_factor
    e_pad = params["wi_gate"].shape[0]
    y, (ls, ps, zs, t) = _moe_local(cfg, params, x2d, e_pad=e_pad,
                                    capacity_factor=cf, dropless=dropless)
    if "shared" in params:
        y = y + mlp(cfg, params["shared"], x2d)
    return y.reshape(B, S, d), _aux_from_stats(cfg, ls, ps, zs, t)
