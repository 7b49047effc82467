"""Mixture-of-Experts layer, ported from ``src/repro/models/moe.py``: on
one device (the reference's ``spmd=None`` path) and expert-parallel over
a mesh (``MoESpmd``, below).

Per call: router logits, then one call of the routing kernel's wrapper
(``router_dispatch``: padded experts masked to -1e30, top-k routing, each
of the T·k assignments' capacity slot in (token, choice) order — the
reference's stable sort over experts, ``dispatch="sort"``, or running
count, ``"cumsum"`` — and the aux sums), a gather of the token rows into
an (E, C, d) buffer, the experts' SwiGLU FFNs as batched products, and
each token's k weighted expert outputs gathered back and summed.
Assignments past an expert's capacity C = ceil(T·k/E · cf) are dropped
and contribute zero; serving runs dropless (C = T: an expert can receive
each token at most once), training at the config's capacity factor
(``dropless=False``).  Every shape is fixed, so a layer call makes
the host wait for nothing.  The expert products stay ``torch.bmm``, as
the reference leaves its einsums to XLA.

The combine (each token's k weighted expert outputs, summed in choice
order) is one launch, ``moe_combine`` (``csrc/moe_combine.cu``).

Gradients: routing runs on the detached logits and carries no autograd
node; ``CombineFunction`` takes the logits and the experts' outputs and
returns y and the aux sums, so the router's gradient (from the combine
weights and the aux sums) comes from its backward, ``moe_combine_bwd``:
one launch that writes the experts' outputs' gradient and the logits'
(the router's row function shared with ``router_bwd``, which the layer
no longer launches).  The token rows' gather into the
capacity buffer is ``_Dispatch``, whose backward is a gather too (each
token's k slots summed in choice order), not ``index_select``'s
backward, which scatters with ``index_add_``: a token repeated k times
would be summed in whatever order the atomics run.

**Expert parallelism** (``spmd=MoESpmd(...)``, the reference's
``shard_map`` path).  The experts lie along the mesh axis
``expert_axis``: shard i holds experts [i·e_local, (i+1)·e_local), and
every shard of a token row holds the row's tokens.  Each shard routes its
tokens over all experts (the router weight is whole everywhere), gives
slots only to the assignments to its own experts (the routing kernel's
expert range), runs its experts and combines their partial outputs; the
partials are summed over the expert axis.  The aux sums (identical on
every expert shard) are summed over the token axes, so every rank holds
the global aux losses.  Capacity is per token shard, as the reference's.

The gradients across ranks are the unsharded layer's (tested against
it), by three named rules from ``distrib/collectives.py``:
``CopyToAxes`` at the layer's input and at the router weight (identity
forward; backward, the sum over the expert axis of each shard's partial
gradient), ``ReduceFromAxes`` at the output (the sum forward, identity
backward), and ``SumOnce`` on the aux sums (the sum over the token axes;
its gradient summed back over them and counted on one expert shard
only).  A shared expert (deepseek) is plain tensor parallel, as the
reference lays it out: where its ``mlp`` dim is split along the expert
axis, each shard runs its slice on the layer's input (after the same
``CopyToAxes``) and adds its partial to the experts' partials before the
one ``ReduceFromAxes`` of the layer.  Where it is whole, it runs whole on
every shard after that sum.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distrib.collectives import (CopyToAxes, ReduceFromAxes, SumOnce,
                                   all_reduce)
from ..kernels.moe_combine import CombineFunction, moe_combine
from ..kernels.moe_router import router_dispatch
from .common import (dense_init, dtype_of, mlp, mlp_axes, mlp_params,
                     mlp_partial)


@dataclass(frozen=True)
class MoESpmd:
    """How the MoE layer sees the mesh: the axes that split the tokens
    (``("pod", "data")``), and the axis the experts lie along
    (``expert_axis=None``: every rank holds all experts)."""
    mesh: object                      # launch.mesh.Mesh
    token_axes: Tuple[str, ...]
    expert_axis: Optional[str] = "model"

    @property
    def n_expert_shards(self) -> int:
        if self.expert_axis is None:
            return 1
        return self.mesh.shape[self.expert_axis]


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


def moe_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``moe_params``' leaves, as the reference's
    ``moe_params`` tags them: the router replicated over the experts
    (every shard needs the global top-k)."""
    p = {"router": ("embed", "experts_unsharded"),
         "wi_gate": ("experts", "embed", "mlp"),
         "wi_up": ("experts", "embed", "mlp"),
         "wo": ("experts", "mlp", "embed")}
    if cfg.moe.num_shared_experts:
        p["shared"] = mlp_axes(cfg)
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


class _Dispatch(torch.autograd.Function):
    """buf[s] = x[src[s]] (a zero row where src[s] == T), and back:
    dx[t] = Σ_j dbuf[slot[t, j]] in choice order, a dropped assignment's
    slot (E·C) reading a zero row.  No atomics: the same inputs give the
    same gradient on every run."""

    @staticmethod
    def forward(ctx, x2d, src, slot):
        ctx.save_for_backward(slot)
        x_pad = torch.cat([x2d, x2d.new_zeros((1, x2d.shape[1]))])
        return x_pad.index_select(0, src)

    @staticmethod
    def backward(ctx, dbuf):
        slot, = ctx.saved_tensors
        T, k = slot.shape
        d_pad = torch.cat([dbuf, dbuf.new_zeros((1, dbuf.shape[1]))])
        dx = d_pad.index_select(0, slot.reshape(-1)).view(T, k, -1).sum(1)
        return dx, None, None


def _moe_local(cfg: ModelConfig, params: dict, x2d, *, e_pad: int,
               capacity_factor: float, dropless: bool = False,
               e_start: int = 0, e_local: Optional[int] = None):
    """Dispatch + expert FFN over x2d: (T, d); the expert tensors hold
    experts [e_start, e_start + e_local) (default all ``e_pad``).  Returns
    y (T, d), the contributions of those experts only, and the aux sums
    over all experts (load per expert, prob per expert, router z, T).
    Every shape is fixed by T, k, E and C: nothing waits for the card."""
    e_local = e_pad if e_local is None else e_local
    T, d = x2d.shape
    E_real, k = cfg.moe.num_experts, cfg.moe.top_k
    cdt = dtype_of(cfg.compute_dtype)

    logits = (x2d.to(cdt) @ params["router"].to(cdt)).float()   # (T, E)
    if dropless:
        C = T
    else:
        C = max(int(math.ceil(T * k / max(E_real, 1) * capacity_factor)), 1)
    r = router_dispatch(logits.detach(), k, n_real=E_real, capacity=C,
                        dispatch=cfg.moe.dispatch, e_start=e_start,
                        e_local=e_local)

    # each capacity slot's token row, a zero row where the slot is empty
    buf = _Dispatch.apply(x2d, r.src, r.slot).view(e_local, C, d)
    out_buf = _expert_ffn(cfg, params, buf).view(e_local * C, d)
    del buf

    # each token's k weighted expert outputs, summed in choice order in
    # f32 (no atomics: the same inputs give the same sum on the card); a
    # dropped assignment contributes nothing, as the reference's
    # out-of-bounds gather with mode="fill"
    if torch.is_grad_enabled() and (logits.requires_grad
                                    or out_buf.requires_grad):
        y, prob_sum, z_sum = CombineFunction.apply(
            logits, out_buf, r.probs, r.idx, r.w, r.slot, r.src,
            r.prob_sum, r.z_sum, E_real)
    else:
        y, prob_sum, z_sum = moe_combine(out_buf, r.w, r.slot), \
            r.prob_sum, r.z_sum
    return y, (r.load, prob_sum, z_sum, float(T))


def _aux_from_stats(cfg: ModelConfig, load_sum, prob_sum, z_sum, t_total):
    E_real, k = cfg.moe.num_experts, cfg.moe.top_k
    frac_load = (load_sum / max(t_total * k, 1.0))[:E_real]
    frac_prob = (prob_sum / max(t_total, 1.0))[:E_real]
    lb = E_real * torch.sum(frac_load * frac_prob)
    z = z_sum / max(t_total, 1.0)
    return {"moe_lb": lb * cfg.moe.aux_coef,
            "moe_z": z * cfg.moe.router_z_coef}


def moe_apply(cfg: ModelConfig, params: dict, x, *,
              spmd: Optional[MoESpmd] = None,
              capacity_factor: Optional[float] = None,
              dropless: bool = False,
              want_aux: bool = True) -> Tuple[torch.Tensor, dict]:
    """MoE FFN over x: (B, S, d).  Returns (y, aux_losses).

    With ``spmd``, x holds this rank's tokens, the router is whole and
    the expert tensors hold this rank's experts along
    ``spmd.expert_axis``; y is the sum over the expert shards and the aux
    losses are over every token of the mesh.  Serving, which drops the
    aux losses, passes ``want_aux=False``: their sums over the mesh are
    then not taken (aux_losses is {})."""
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    cf = capacity_factor if capacity_factor is not None \
        else cfg.moe.capacity_factor
    if spmd is None:
        e_pad = params["wi_gate"].shape[0]
        y, (ls, ps, zs, t) = _moe_local(cfg, params, x2d, e_pad=e_pad,
                                        capacity_factor=cf,
                                        dropless=dropless)
        if "shared" in params:
            y = y + mlp(cfg, params["shared"], x2d)
        return y.reshape(B, S, d), _aux_from_stats(cfg, ls, ps, zs, t)

    mesh, ex, tok = spmd.mesh, spmd.expert_axis, tuple(spmd.token_axes)
    e_pad = params["router"].shape[1]
    e_local = params["wi_gate"].shape[0]
    if e_local * spmd.n_expert_shards != e_pad:
        raise ValueError(f"moe_apply: {e_local} local experts on "
                         f"{spmd.n_expert_shards} shards are not the "
                         f"router's {e_pad}")
    local = dict(params)
    x_in = x2d
    if ex is not None:
        x_in = CopyToAxes.apply(x2d, mesh, ex)
        local["router"] = CopyToAxes.apply(params["router"], mesh, ex)
    y, (ls, ps, zs, t) = _moe_local(
        cfg, local, x_in, e_pad=e_pad, capacity_factor=cf,
        dropless=dropless, e_start=mesh.coords[ex] * e_local if ex else 0,
        e_local=e_local)
    shared = params.get("shared")
    if shared is not None and ex is not None and (
            shared["wo"].shape[0] < cfg.moe.num_shared_experts * cfg.d_ff):
        # this shard's slice of the shared expert: its partial joins the
        # experts' partials
        y = y + mlp_partial(cfg, shared, x_in)
        shared = None
    if ex is not None:
        y = ReduceFromAxes.apply(y, mesh, ex)      # combine expert partials
    if shared is not None:
        y = y + mlp(cfg, shared, x2d)
    if not want_aux:
        return y.reshape(B, S, d), {}
    # identical on every expert shard: summed over the token shards
    ps = SumOnce.apply(ps, mesh, tok, ex)
    zs = SumOnce.apply(zs, mesh, tok, ex)
    if tok:
        ls = all_reduce(ls, mesh, tok)
        t = t * mesh.axis_size(tok)
    return y.reshape(B, S, d), _aux_from_stats(cfg, ls, ps, zs, t)
