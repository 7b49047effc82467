"""The plain reference of a DeepSeekMoE decoder configuration (the family
``moe_decoder``; DeepSeekMoE, arXiv:2401.06066): its training loss and
gradients in float32 with TF32 off.

It reads only a configuration file's keys (Hugging Face names) and the
benchmark's stacked weights, and imports nothing of the program.  The
attention, the norms, the embedding and the head are the dense
reference's (``decoder.py``).  The first ``first_k_dense_replace``
layers keep a SwiGLU MLP of ``intermediate_size``; every later layer's
feed-forward half is a mixture of experts:

* router logits x·W_r in f32, the softmax over all ``n_routed_experts``
  (``scoring_func`` softmax; no other is taken), the
  ``num_experts_per_tok`` largest (ties to the lower expert), their
  weights renormalised to sum 1 only where ``norm_topk_prob``;
* with a ``capacity_factor``, each expert keeps its first
  C = ceil(T·k/E·cf) assignments of the T tokens of the batch in (token,
  choice) order and drops the rest; with ``capacity_factor`` null
  (dropless) it keeps all of them;
* the output: the sum over the kept choices of w·SwiGLU_e(x) (experts of
  ``moe_intermediate_size``), plus the shared experts' SwiGLU of width
  ``n_shared_experts``·``moe_intermediate_size``;
* the balance loss α·Σ_i f_i·P_i (α ``aux_loss_alpha``), f_i = E/(k·T)
  times the tokens choosing expert i (dropped ones too), P_i the mean
  over the tokens of s_i; with ``seq_aux`` taken per sequence and
  averaged over the batch, otherwise over the whole batch;
* where the file gives ``router_z_loss_coef``, that times the mean
  squared log-sum-exp of the router logits.

Each layer's balance and z losses join the training loss.  The capacity
and the balance loss couple the batch's sequences, so ``loss_grads``
runs the whole batch at once, each layer and each sequence's head
recomputed in the backward, all in f32 with TF32 off.  Under ``quant``
every linear layer runs in float8, the router's and every expert's
products included.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import decoder
from .common import f32_exact, linear, rms_norm, swiglu


class Layout(decoder.Layout):
    """A DeepSeekMoE configuration file's sizes and routing rules."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        if cfg["scoring_func"] != "softmax":
            raise ValueError(f"scoring_func {cfg['scoring_func']!r}: only "
                             "softmax is modelled")
        if cfg.get("moe_layer_freq", 1) != 1:
            raise ValueError("moe_layer_freq other than 1 is not modelled")
        self.E = cfg["n_routed_experts"]
        self.k = cfg["num_experts_per_tok"]
        self.shared = cfg["n_shared_experts"]
        self.f = cfg["moe_intermediate_size"]
        self.dense = cfg["first_k_dense_replace"]
        self.moe_layers = self.L - self.dense
        self.norm_topk = bool(cfg["norm_topk_prob"])
        self.cf = cfg["capacity_factor"]
        self.alpha = float(cfg["aux_loss_alpha"])
        self.seq_aux = bool(cfg["seq_aux"])
        self.z = float(cfg.get("router_z_loss_coef") or 0.0)


def route(logits: torch.Tensor, k: int, norm_topk: bool):
    """Softmax gating of ``logits`` (T, E): (probabilities (T, E), the k
    chosen weights (T, k), their experts (T, k)); equal probabilities in
    ascending expert order."""
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    if norm_topk:
        w = w / w.sum(-1, keepdim=True)
    return probs, w, idx


def capacity(lay: Layout, T: int) -> Optional[int]:
    """Assignments an expert keeps of a batch of T tokens (None: all)."""
    if lay.cf is None:
        return None
    return math.ceil(T * lay.k / lay.E * lay.cf)


def kept(idx: torch.Tensor, E: int, cap: Optional[int]) -> torch.Tensor:
    """(T, k) bool: whether assignment (t, j) is among the first ``cap``
    to its expert in (token, choice) order."""
    if cap is None:
        return torch.ones_like(idx, dtype=torch.bool)
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, E)
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, flat[:, None])
    return (before[:, 0] < cap).view(idx.shape)


def balance(probs: torch.Tensor, idx: torch.Tensor, E: int, k: int,
            B: int, seq_aux: bool) -> torch.Tensor:
    """Σ_i f_i·P_i over the batch, or its mean over the B sequences."""
    G = B if seq_aux else 1
    n = probs.shape[0] // G                      # tokens a group
    count = F.one_hot(idx.reshape(G, n * k), E).sum(1).float()   # (G, E)
    f = count * (E / (k * n))
    P = probs.view(G, n, E).mean(1)
    return (f * P).sum(-1).mean()


def moe(x: torch.Tensor, w: Dict[str, torch.Tensor], j: int, lay: Layout,
        B: int, quant: Optional[str]):
    """MoE layer ``j`` (counted among the MoE layers) over the batch's rows
    x (T, d): (its output (T, d), its balance and z losses)."""
    T = x.shape[0]
    logits = linear(x, w["router"][j], quant)
    probs, gate, idx = route(logits, lay.k, lay.norm_topk)
    keep = kept(idx, lay.E, capacity(lay, T)).reshape(-1)
    token = torch.arange(T, device=x.device).repeat_interleave(lay.k)
    expert, gate = idx.reshape(-1), gate.reshape(-1)
    y = torch.zeros_like(x)
    for e in range(lay.E):
        sel = torch.nonzero(keep & (expert == e))[:, 0]
        if sel.numel() == 0:
            continue
        t = token[sel]
        out = swiglu(x[t], w["expert_wi_gate"][j, e], w["expert_wi_up"][j, e],
                     w["expert_wo"][j, e], quant)
        y = y.index_add(0, t, out * gate[sel, None])
    if lay.shared:
        y = y + swiglu(x, w["shared_wi_gate"][j], w["shared_wi_up"][j],
                       w["shared_wo"][j], quant)
    aux = lay.alpha * balance(probs, idx, lay.E, lay.k, B, lay.seq_aux)
    if lay.z:
        aux = aux + lay.z * torch.square(torch.logsumexp(logits, -1)).mean()
    return y, aux


class Model(decoder.Model):
    """The reference model of a DeepSeekMoE configuration file ``cfg``
    over stacked weights ``w`` (any dtype; read in f32)."""

    layout = Layout

    def layer(self, x, i, pos):
        """Layer ``i`` over the batch's rows x (B, S, d): (its output, its
        balance and z losses)."""
        w, lay, B = self.w, self.lay, x.shape[0]
        h = rms_norm(x, w["norm1"][i], self.eps)
        x = x + torch.stack([self.attention(h[b], i, pos)
                             for b in range(B)])
        h = rms_norm(x, w["norm2"][i], self.eps).reshape(-1, lay.d)
        if i < lay.dense:
            y = swiglu(h, w["dense_wi_gate"][i], w["dense_wi_up"][i],
                       w["dense_wo"][i], self.quant)
            aux = h.new_zeros(())
        else:
            y, aux = moe(h, w, i - lay.dense, lay, B, self.quant)
        return x + y.view(x.shape), aux

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor,
             lm_z: float) -> torch.Tensor:
        """The training loss of ``tokens`` / ``targets`` (B, S): the mean
        cross entropy, ``lm_z`` times the mean squared log-sum-exp, and
        every layer's balance and z losses."""
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)
        with f32_exact():
            x = self.w["embedding"][tokens.long()].float()
            total = x.new_zeros(())
            for i in range(self.lay.L):
                x, aux = checkpoint(self.layer, x, i, pos,
                                    use_reentrant=False)
                total = total + aux
            for b in range(B):
                total = total + checkpoint(self.seq_loss, x[b], targets[b],
                                           lm_z, B * S, use_reentrant=False)
        return total

    def loss_grads(self, tokens: torch.Tensor, targets: torch.Tensor,
                   lm_z: float):
        """The training loss and its gradient for every weight."""
        names = list(self.w)
        total = self.loss(tokens, targets, lm_z)
        with f32_exact():        # the backward recomputes the layers
            got = torch.autograd.grad(total, [self.w[n] for n in names],
                                      allow_unused=True)
        grads = {n: torch.zeros_like(self.w[n]) if g is None else g
                 for n, g in zip(names, got)}
        return float(total.detach()), grads
