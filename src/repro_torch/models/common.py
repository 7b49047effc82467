"""Model substrate: device choice, seeded init, norms, RoPE, MLPs,
embeddings and the chunked cross-entropy, as
``src/repro/models/common.py`` computes them.

Parameters are plain dicts of tensors.  The numerics follow the
reference: weights are kept in ``cfg.param_dtype`` and cast to
``cfg.compute_dtype`` where they are used; norms, RoPE and serving's
logits are computed in f32, and the loss's logits are reduced in f32.

The MLP, the embedding lookup and the loss take a ``tp``
(``distrib.tensor_parallel.Split``) in the sharded training step: the
MLP's ``mlp`` dim, or the vocabulary, is then this rank's slice of it.
Under sequence parallelism the MLP's input and output and the lookup's
rows are this rank's positions (``Split.enter`` / ``Split.leave``); the
loss always takes the whole sequence.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distrib.collectives import all_reduce
from ..kernels.cross_entropy import cross_entropy


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
class ShapesOnly:
    """Stands in for the generator where only shapes and dtypes are made
    (``Model.init(device="meta")``): every leaf a meta tensor."""
    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype,
               in_dim: Optional[int] = None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, as the reference's ``dense_p``."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = in_dim if in_dim is not None else shape[0]
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: a bf16 leaf's draw holds one f32 copy, not two
    return w.div_(math.sqrt(max(fan_in, 1))).to(dtype)


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
def mlp_params(cfg: ModelConfig, gen: torch.Generator,
               d_ff: Optional[int] = None) -> dict:
    """A dense MLP of width ``d_ff`` (default ``cfg.d_ff``): MoE shared
    experts and deepseek's dense first layer take their own widths."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg.param_dtype)
    p = {}
    if cfg.mlp in ("swiglu", "geglu"):
        p["wi_gate"] = dense_init(gen, (d, f), dt)
        p["wi_up"] = dense_init(gen, (d, f), dt)
    else:
        p["wi"] = dense_init(gen, (d, f), dt)
    p["wo"] = dense_init(gen, (f, d), dt, in_dim=f)
    return p


def mlp_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``mlp_params``' leaves, as the reference tags
    them (``models/common.py``, ``mlp_params``)."""
    if cfg.mlp in ("swiglu", "geglu"):
        p = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp")}
    else:
        p = {"wi": ("embed", "mlp")}
    p["wo"] = ("mlp", "embed")
    return p


def mlp(cfg: ModelConfig, p: dict, x, tp=None):
    """The MLP; under ``tp`` its input products are column-parallel and
    its output product row-parallel (the rank's slice of ``mlp``): x
    enters through ``tp.enter`` and the partial outputs are summed by
    ``tp.leave``."""
    if tp is None:
        return mlp_partial(cfg, p, x)
    return tp.leave(mlp_partial(cfg, p, tp.enter(x)))


def mlp_partial(cfg: ModelConfig, p: dict, x):
    """The MLP over the ``mlp`` columns that ``p`` holds (all of them
    without tensor parallelism)."""
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
    if cfg.frontend != "none" and cfg.frontend_dim:
        p["frontend_proj"] = dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                        dt)
    return p


def embed_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``embed_params``' leaves, as the reference's
    ``embed_params`` tags them."""
    p = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        p["head"] = ("embed", "vocab")
    if cfg.frontend != "none" and cfg.frontend_dim:
        p["frontend_proj"] = ("frontend", "embed")
    return p


def embed_tokens(cfg: ModelConfig, p: dict, tokens, tp=None):
    """The token rows (B,S,d) in the compute dtype.  Under ``tp`` the
    table holds this rank's slice of the vocabulary: the rank looks up
    the ids in its range, zeros the others, and ``tp.leave`` sums the
    ranks' rows (one nonzero term each: the rows are exact); under
    sequence parallelism it keeps this rank's positions of the sum."""
    cdt = dtype_of(cfg.compute_dtype)
    if tp is None:
        h = p["embedding"][tokens.long()].to(cdt)
    else:
        table = p["embedding"]
        ids, mine = _vocab_slice(tokens, table.shape[0], tp)
        h = tp.leave(table[ids].masked_fill(~mine[..., None], 0).to(cdt))
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


def _vocab_slice(ids, v_local: int, tp):
    """(ids into this rank's slice of the vocabulary, clamped into it;
    which ids fall in it)."""
    local = ids.long() - tp.rank * v_local
    mine = (local >= 0) & (local < v_local)
    return local.clamp(0, v_local - 1), mine


# ---------------------------------------------------------------------------
# cross-entropy (chunked over the sequence)
# ---------------------------------------------------------------------------
def chunked_ce_loss(cfg: ModelConfig, p: dict, h, targets, *,
                    chunk: int = 512, z_coef: float = 1e-4,
                    ignore_id: int = -1, tp=None):
    """Softmax CE + z-loss without holding (B,S,V) logits at once, as the
    reference's ``chunked_ce_loss``.

    h: (B,S,d) final hidden states; targets: (B,S) integers, ``ignore_id``
    where a position has no target.  Returns (loss, {"ce", "z_loss",
    "tokens"}).  Over the whole vocabulary (``tp`` None) the head runs in
    ``head_loss``: each sequence chunk's (B·c, V) logits in the compute
    dtype, reduced by the ``cross_entropy`` kernel, which with a gradient
    to form writes the logits' gradient over them; the gradients of h and
    the table are formed there, in the forward (``HeadLossFunction``), and
    ``ce`` and ``z_loss`` carry none.  Under ``tp`` (vocabulary-parallel)
    ``_vocab_parallel_ce`` runs."""
    if tp is not None:
        return _vocab_parallel_ce(cfg, p, h, targets, chunk=chunk,
                                  z_coef=z_coef, ignore_id=ignore_id, tp=tp)
    table = p["embedding"] if cfg.tie_embeddings else p["head"]
    n = (targets != ignore_id).sum().clamp_min(1)
    args = (cfg, chunk, z_coef, ignore_id)
    if torch.is_grad_enabled() and (h.requires_grad or table.requires_grad):
        loss, ce, z = HeadLossFunction.apply(h, table, targets, n, *args)
    else:
        ce, z, _, _ = head_loss(h, table, targets, n, *args)
        loss = ce + z_coef * z
    return loss, {"ce": ce, "z_loss": z, "tokens": n}


def head_loss(h, table, targets, n, cfg: ModelConfig, chunk: int,
              z_coef: float, ignore_id: int, need_dh: bool = False,
              need_dw: bool = False):
    """(ce, z, dh, dw) of the head over the whole vocabulary: the table
    (the tied (V,d) embedding, used transposed, or the (d,V) head) cast to
    the compute dtype once; each chunk of c positions forms its (B·c, V)
    logits in one reused buffer and ``cross_entropy`` reduces them.  With
    ``need_dh`` or ``need_dw`` the kernel leaves the logits' gradient in
    the buffer (``n`` tokens counted, the upstream gradient taken as 1),
    and the chunk's dh = dlogits·W (h's dtype) and dW += its product with
    the chunk's rows (in the compute dtype, summed in f32; the table's
    dtype at the end) are formed at once; otherwise they are None."""
    cdt = dtype_of(cfg.compute_dtype)
    B, S, d = h.shape
    tied = cfg.tie_embeddings
    w = table.to(cdt)
    V = w.shape[0] if tied else w.shape[1]
    c = min(chunk, S)
    buf = torch.empty((B * c, V), dtype=cdt, device=h.device)
    grad = need_dh or need_dw
    dh = torch.empty_like(h) if need_dh else None
    dw = torch.zeros(table.shape, dtype=torch.float32,
                     device=table.device) if need_dw else None
    dw_c = torch.empty_like(w) if need_dw else None
    nll, zsq = [], []
    for i in range(0, S, c):
        cc = min(c, S - i)
        rows = h[:, i:i + cc].reshape(B * cc, d).to(cdt)
        logits = buf[:B * cc]
        torch.mm(rows, w.t() if tied else w, out=logits)
        _, nll_c, zsq_c = cross_entropy(
            logits, targets[:, i:i + cc].reshape(B * cc).long(), n,
            softcap=cfg.logit_softcap, z_coef=z_coef, ignore_id=ignore_id,
            grad=grad)
        nll.append(nll_c)
        zsq.append(zsq_c)
        if need_dh:
            dh[:, i:i + cc] = torch.mm(logits, w if tied else w.t()).view(
                B, cc, d)
        if need_dw:
            if tied:
                torch.mm(logits.t(), rows, out=dw_c)
            else:
                torch.mm(rows.t(), logits, out=dw_c)
            dw.add_(dw_c)
    ce = torch.cat(nll).sum() / n
    z = torch.cat(zsq).sum() / n
    return ce, z, dh, None if dw is None else dw.to(table.dtype)


class HeadLossFunction(torch.autograd.Function):
    """The head's loss over the whole vocabulary with its gradient formed
    in the forward: ``head_loss`` runs once, keeps dh and dW, and returns
    (ce + z_coef·z, ce, z), the last two without a gradient.  The backward
    scales the kept gradients by the loss's upstream one (1 in a training
    step) in place; no head product is formed again."""

    @staticmethod
    def forward(ctx, h, table, targets, n, cfg, chunk, z_coef, ignore_id):
        ce, z, dh, dw = head_loss(h, table, targets, n, cfg, chunk, z_coef,
                                  ignore_id,
                                  need_dh=ctx.needs_input_grad[0],
                                  need_dw=ctx.needs_input_grad[1])
        ctx.grads = (dh, dw)
        ctx.mark_non_differentiable(ce, z)
        return ce + z_coef * z, ce, z

    @staticmethod
    def backward(ctx, g, _ce, _z):
        dh, dw = ctx.grads
        ctx.grads = None
        return ((None if dh is None else dh.mul_(g)),
                (None if dw is None else dw.mul_(g))) + (None,) * 6


def _vocab_parallel_ce(cfg: ModelConfig, p: dict, h, targets, *,
                       chunk: int, z_coef: float, ignore_id: int, tp):
    """``chunked_ce_loss`` under ``tp``: each rank forms its (B,c,V/n)
    chunk of f32 logits, softcap applied; the lse takes the max over the
    ranks (an all-reduce MAX, no gradient) and the sum of their
    exponentials (``tp.sum``); the target logit comes from the rank
    whose slice holds it (``tp.sum`` of one nonzero term).  The chunk's
    input, whole on every rank, passes ``tp.shared``, which sums its
    partial gradients.  Each chunk runs under ``torch.utils.checkpoint``,
    so autograd keeps only its (B,c,d) input and recomputes the logits in
    the backward.  Every rank then holds the same loss."""
    B, S, _ = h.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=ignore_id)

    def lse_and_target(logits, tc):
        m = all_reduce(logits.detach().amax(dim=-1), tp.mesh, tp.axis,
                       "max")
        lse = m + torch.log(tp.sum(torch.exp(logits - m[..., None])
                                   .sum(dim=-1)))
        ids, mine = _vocab_slice(tc, logits.shape[-1], tp)
        tgt = logits.gather(-1, ids[..., None])[..., 0]
        return lse, tp.sum(tgt.masked_fill(~mine, 0.0))

    def body(hc, tc):
        hc = tp.shared(hc)
        logits = unembed(cfg, p, hc)                      # (B,c,V) f32
        lse, tgt = lse_and_target(logits, tc)             # (B,c)
        valid = tc != ignore_id
        nll = torch.where(valid, lse - tgt, 0.0)
        zl = torch.where(valid, torch.square(lse), 0.0)
        return nll.sum(), zl.sum()

    loss_sum = z_sum = 0.0
    for i in range(0, S + pad, c):
        hc, tc = h[:, i:i + c], targets[:, i:i + c]
        nll, zl = checkpoint(body, hc, tc, use_reentrant=False)
        loss_sum = loss_sum + nll
        z_sum = z_sum + zl
    n = (targets != ignore_id).sum().clamp_min(1)
    ce = loss_sum / n
    z = z_sum / n
    return ce + z_coef * z, {"ce": ce, "z_loss": z, "tokens": n}
