"""Collectives on a ``launch.mesh.Mesh``, ported from
``src/repro/distrib/collectives.py``, and the gradient rules of the
collectives that the expert-parallel MoE layer runs inside autograd.

``all_reduce`` reduces over mesh axes.  Floating tensors travel in f32
(a bf16 or f16 tensor is widened for the reduction and rounded back
once), integers in int32 or int64.  With ``keep_dtype`` a tensor travels
in its own dtype: the 16-bit parameter gathers and their gradients'
reduce-scatters (``ParallelConfig.param_gather_dtype``) move 16-bit
values in every form, and a backend that refuses the dtype raises.

``all_gather_dim`` / ``reduce_scatter_dim`` gather the blocks of a
tensor split along one dimension, and sum whole tensors keeping this
rank's block.  They take one of two forms, which ``collective_form``
picks from the mesh's backend and the tensor's device, and nothing
else (no fallback on failure, no flag):

* ``"direct"`` (NCCL; gloo with CPU tensors): one all-gather or one
  reduce-scatter call over dim 0 of an ``(n, *block)`` buffer.  A
  block split along another dimension is moved into place after the
  gather (one copy of the gathered tensor) and out of place before the
  reduce-scatter (one copy of the whole gradient).
* ``"all_reduce"`` (gloo with CUDA tensors, which gloo takes only for
  all-reduce and broadcast): a gather all-reduces a zero buffer holding
  this rank's block at its place, a reduce-scatter all-reduces the
  whole tensor and keeps the block.  Ring all-reduce moves about twice
  the bytes of the direct call.

``compressed_psum`` — int8-quantised mean all-reduce with error feedback:
a shared per-tensor scale (an all-reduce MAX), the int8 payload widened
to int32 and summed, divided by n, and the local quantisation error
returned so that the caller can fold it into the next step's input.
The reference's arithmetic in the reference's order.

``sp_decode_attention`` — the two-pass sequence-parallel decode softmax
over a KV cache sharded along the sequence: each rank's partial is the
hand-written attention kernel's forward over its block of keys, which
writes the row lse beside the normalised output; an all-reduce MAX of
lse and two all-reduce SUMs combine them.  The payload is O(B·H·D),
independent of T.

``record()`` lists every collective call the functions here make, as
``{"op", "result_bytes", "group"}`` (the reference dry run's records of
its compiled program: the result's bytes, the ranks of its group): a
real run's and a dry run's list can be held against each other call for
call.

The gradient rules (``CopyToAxes``, ``ReduceFromAxes``, ``SumOnce``,
``GatherFromAxes``, ``ReduceScatterToAxes``) are named
``autograd.Function``s, each beside the collective it runs.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..kernels.attention import attention_fwd
from .sharding import gather_block, local_block, reduce_scatter_block

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}
# the dtype each dtype is reduced in
_WIRE = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.bfloat16: torch.float32, torch.float16: torch.float32,
         torch.int32: torch.int32, torch.int64: torch.int64,
         torch.int8: torch.int32, torch.uint8: torch.int32}


_records: Optional[list] = None     # record()'s list while it is active


@contextlib.contextmanager
def record():
    """Yields the list of the collective calls made under it, in order:
    ``{"op": "all-reduce" | "all-gather" | "reduce-scatter", "result_bytes":
    the result's bytes, "group": its ranks, "span": the consecutive ranks
    from its lowest to its highest}``."""
    global _records
    prev, _records = _records, []
    try:
        yield _records
    finally:
        _records = prev


def _note(op: str, result: torch.Tensor, mesh, axes) -> None:
    if _records is not None:
        _records.append({"op": op, "group": mesh.axis_size(axes),
                         "span": mesh.span(axes),
                         "result_bytes": result.numel()
                         * result.element_size()})


def all_reduce_(x: torch.Tensor, mesh, axes, op: str = "sum"
                ) -> torch.Tensor:
    """Reduce ``x`` over the mesh axes ``axes`` in place and return it;
    ``x`` must be in a dtype the wire takes as it is (f32, f64, int32,
    int64)."""
    if _WIRE.get(x.dtype) is not x.dtype:
        raise ValueError(f"all_reduce_: {x.dtype} does not travel as it is")
    if not x.is_contiguous():
        raise ValueError("all_reduce_: x must be contiguous")
    # a 0-d tensor travels as one element of the same storage
    dist.all_reduce(x.view(-1) if x.ndim == 0 else x, op=_OPS[op],
                    group=mesh.group(axes))
    _note("all-reduce", x, mesh, axes)
    return x


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum",
               keep_dtype: bool = False) -> torch.Tensor:
    """A new tensor: ``x`` reduced over the mesh axes ``axes`` (``op``:
    sum, max or min), in ``x``'s dtype; with ``keep_dtype`` it travels in
    that dtype too."""
    if keep_dtype:
        buf = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf.view(-1) if buf.ndim == 0 else buf,
                        op=_OPS[op], group=mesh.group(axes))
        _note("all-reduce", buf, mesh, axes)
        return buf
    wire = _WIRE.get(x.dtype)
    if wire is None:
        raise ValueError(f"all_reduce: no wire dtype for {x.dtype}")
    buf = x.to(wire, copy=True).contiguous()
    return all_reduce_(buf, mesh, axes, op).to(x.dtype)


# the names of the all-gather and reduce-scatter calls that fill and read
# a flat (n, *block) buffer: newer torch deprecates the older names
_ALL_GATHER = ("all_gather_single" if hasattr(dist, "all_gather_single")
               else "all_gather_into_tensor")
_REDUCE_SCATTER = ("reduce_scatter_single"
                   if hasattr(dist, "reduce_scatter_single")
                   else "reduce_scatter_tensor")


def collective_form(mesh, x: torch.Tensor) -> str:
    """The form a gather or reduce-scatter of ``x`` takes on ``mesh``:
    ``"all_reduce"`` for gloo with a CUDA tensor, else ``"direct"``."""
    return "all_reduce" if mesh.backend == "gloo" and x.is_cuda \
        else "direct"


def all_gather_dim(x: torch.Tensor, mesh, axes, dim: int,
                   keep_dtype: bool = False) -> torch.Tensor:
    """The blocks of every rank of the mesh axes ``axes`` put together
    along ``dim``, in the order of ``mesh.axis_index(axes)``;
    ``keep_dtype``: the all-reduce form's buffer travels in ``x``'s dtype
    (the direct form always does)."""
    if collective_form(mesh, x) == "all_reduce":
        return _gather_by_all_reduce(x, mesh, axes, dim, keep_dtype)
    return _gather_direct(x, mesh, axes, dim)


def reduce_scatter_dim(x: torch.Tensor, mesh, axes, dim: int,
                       keep_dtype: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, and this rank's block
    of it along ``dim`` (``x.shape[dim]`` divides into the ranks), in
    ``x``'s dtype; ``keep_dtype``: summed in it too."""
    if collective_form(mesh, x) == "all_reduce":
        return _scatter_by_all_reduce(x, mesh, axes, dim, keep_dtype)
    return _scatter_direct(x, mesh, axes, dim, keep_dtype)


def _gather_direct(x, mesh, axes, dim):
    n = mesh.axis_size(axes)
    buf = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    getattr(dist, _ALL_GATHER)(buf, x.contiguous(), group=mesh.group(axes))
    _note("all-gather", buf, mesh, axes)
    if dim == 0:
        return buf
    shape = list(x.shape)
    shape[dim] *= n
    # (n, ..., b, ...) -> (..., n, b, ...): each block moved into place
    return buf.view((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def _gather_by_all_reduce(x, mesh, axes, dim, keep_dtype=False):
    n, idx = mesh.axis_size(axes), mesh.axis_index(axes)
    shape = list(x.shape)
    shape[dim] *= n
    whole = x.new_zeros(shape)
    whole.narrow(dim, idx * x.shape[dim], x.shape[dim]).copy_(x)
    return all_reduce(whole, mesh, axes, keep_dtype=keep_dtype)


def _scatter_direct(x, mesh, axes, dim, keep_dtype=False):
    n = mesh.axis_size(axes)
    wire = x.dtype if keep_dtype else _WIRE[x.dtype]
    b = x.shape[dim] // n
    # (..., n·b, ...) -> (n, ..., b, ...): each rank's block in one row
    src = x.to(wire).reshape(*x.shape[:dim], n, b, *x.shape[dim + 1:]
                             ).movedim(dim, 0).contiguous()
    out = src.new_empty(src.shape[1:])
    getattr(dist, _REDUCE_SCATTER)(out, src.view(-1, *src.shape[2:]),
                                   group=mesh.group(axes))
    _note("reduce-scatter", out, mesh, axes)
    return out.to(x.dtype)


def _scatter_by_all_reduce(x, mesh, axes, dim, keep_dtype=False):
    n, idx = mesh.axis_size(axes), mesh.axis_index(axes)
    b = x.shape[dim] // n
    return all_reduce(x, mesh, axes, keep_dtype=keep_dtype).narrow(
        dim, idx * b, b).contiguous()


# ---------------------------------------------------------------------------
# gradient rules
# ---------------------------------------------------------------------------
class CopyToAxes(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over ``axes``.  A
    tensor replicated over ``axes`` that feeds computations whose
    gradients are partial there (each expert shard's share of the
    router's logits and of the token rows) gets the whole gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axes), None, None


class ReduceFromAxes(torch.autograd.Function):
    """The sum over ``axes`` forward (the expert shards' partial outputs);
    identity backward: each partial's gradient is the sum's."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class SumOnce(torch.autograd.Function):
    """The sum over ``axes`` forward (the MoE aux sums over the token
    shards: every rank then holds the global sums, and its loss the
    global aux losses).  Backward: the gradient summed over ``axes``
    (each token shard's loss is one term of the mean that the step takes
    over them, so no term is scaled down by that mean), kept on the rank
    whose index on ``once_axis`` is 0 and zero on the others: every shard
    along ``once_axis`` computes the same sums, so their gradient must
    count once when the shards' gradients are summed there.  No
    ``axes``: no sum, the gradient still counted once."""

    @staticmethod
    def forward(ctx, x, mesh, axes, once_axis):
        ctx.mesh, ctx.axes, ctx.once_axis = mesh, axes, once_axis
        return all_reduce(x, mesh, axes) if axes else x.clone()

    @staticmethod
    def backward(ctx, g):
        if ctx.axes:
            g = all_reduce(g, ctx.mesh, ctx.axes)
        if ctx.once_axis is not None and ctx.mesh.coords[ctx.once_axis]:
            g = torch.zeros_like(g)
        return g, None, None, None


class GatherFromAxes(torch.autograd.Function):
    """Forward, ``gather_block`` over ``axes`` and ``same``: this rank's
    stored block of a leaf made whole over those axes.  Backward, the
    gradient summed over ``axes`` and this rank's block of the sum kept
    (``reduce_scatter_block``): over the data axes each rank's gradient
    is its own tokens' term, and the caller divides by the token ranks.
    Over ``same`` every rank computed the same whole gradient (a layer
    run whole on every rank of the model axis), so the backward keeps
    this rank's block there without a sum.  ``keep_dtype``: both
    directions travel in the block's dtype (a 16-bit parameter's gather
    and its gradient's reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, spec, mesh, axes, same=(), keep_dtype=False):
        ctx.spec, ctx.mesh, ctx.axes, ctx.same = spec, mesh, axes, same
        ctx.keep_dtype = keep_dtype
        out = gather_block(x, spec, mesh, tuple(axes) + tuple(same),
                           keep_dtype)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        if ctx.same:
            g = local_block(g, ctx.spec, ctx.mesh, ctx.same)
        return (reduce_scatter_block(g, ctx.spec, ctx.mesh, ctx.axes,
                                     ctx.keep_dtype),
                None, None, None, None, None)


class ReduceScatterToAxes(torch.autograd.Function):
    """The reverse of ``GatherFromAxes``: forward, each rank's whole
    tensor summed over ``axes`` and this rank's block of the sum kept
    (``reduce_scatter_block``); backward, the block's gradient gathered
    whole over ``axes`` (``gather_block``): each rank's term of the sum
    takes the whole gradient."""

    @staticmethod
    def forward(ctx, x, spec, mesh, axes):
        ctx.spec, ctx.mesh, ctx.axes = spec, mesh, axes
        return reduce_scatter_block(x, spec, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        out = gather_block(g, ctx.spec, ctx.mesh, ctx.axes)
        return (out.clone() if out is g else out), None, None, None


# ---------------------------------------------------------------------------
# int8 compressed all-reduce with error feedback
# ---------------------------------------------------------------------------
def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation.  Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(x, mesh, axis) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 mean all-reduce of ``x`` (f32) over the mesh axis ``axis``.
    Quantises against the largest scale of the axis, sums the int8
    payload widened to int32 (the wire cost modeled is the int8 payload)
    and dequantises.  Returns (mean-reduced value, local quantisation
    error for feedback)."""
    _, scale = quantize_int8(x)
    n = mesh.axis_size(axis)
    scale_max = all_reduce(scale, mesh, axis, "max")
    # re-quantise against the shared scale so the sum is coherent
    q_shared = torch.clamp(torch.round(x / scale_max), -127,
                           127).to(torch.int8)
    err = x - q_shared.to(torch.float32) * scale_max
    summed = all_reduce_(q_shared.to(torch.int32), mesh, axis)
    out = summed.to(torch.float32) * scale_max / n
    return out, err


def compressed_allreduce_tree(tree, err_tree, mesh, axis):
    """``compressed_psum`` of every leaf of ``tree`` (a dict / list tree
    of f32 tensors) with error feedback from ``err_tree`` (None: zeros).
    Returns (mean-reduced tree, new error tree)."""
    from ..train.optim import leaves, tree_map
    flat = leaves(tree)
    errs = leaves(err_tree) if err_tree is not None else [None] * len(flat)
    res = [compressed_psum(x if e is None else x + e, mesh, axis)
           for x, e in zip(flat, errs)]
    outs = iter(o for o, _ in res)
    new_errs = iter(e for _, e in res)
    return (tree_map(lambda _: next(outs), tree),
            tree_map(lambda _: next(new_errs), tree))


# ---------------------------------------------------------------------------
# sequence-parallel decode attention
# ---------------------------------------------------------------------------
def sp_decode_attention(q, k_local, v_local, mesh, seq_axis="model",
                        softcap: float = 0.0, pos=None,
                        window: int = 0) -> torch.Tensor:
    """Two-pass sequence-parallel decode attention.

    q: (B, 1, Hq, D), the same on every rank of ``seq_axis`` (a mesh axis
    or a tuple of them, the first slowest); k_local, v_local: (B, T/n,
    Hkv, D), this rank's block of the cache along the sequence, block
    ``mesh.axis_index(seq_axis)``.  ``pos`` (an int, a 0-d or a (B,)
    tensor): the query's position in the whole cache, so that the rank's
    partial sees only the keys at or below it (and within ``window``);
    None: every key (decode at the cache's end).  Each rank's partial
    (o, lse) is ``attention_fwd``: the hand-written kernel on the card,
    its plain version on the CPU; a rank whose keys the query cannot see
    gives lse -1e30 and o 0.  Then m = max lse over the ranks, and out =
    Σ o·e^(lse−m) / Σ e^(lse−m).  Returns (B, 1, Hq, D) in q's dtype."""
    if pos is None:
        o, lse = attention_fwd(q, k_local, v_local, causal=False,
                               softcap=softcap)
    else:
        start = mesh.axis_index(seq_axis) * k_local.shape[1]
        o, lse = attention_fwd(q, k_local, v_local, causal=True,
                               window=window, softcap=softcap,
                               q_offset=pos - start)     # lse (B, Hq, 1)
    lse = lse.transpose(1, 2)                           # (B, 1, Hq)
    m = all_reduce(lse, mesh, seq_axis, "max")
    w = torch.exp(lse - m)
    num = all_reduce_(o.float() * w[..., None], mesh, seq_axis)
    den = all_reduce_(w.contiguous(), mesh, seq_axis)
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
