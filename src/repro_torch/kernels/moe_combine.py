"""The MoE combine and its backward, with the router's: the hand-written
Hopper kernels and their plain versions.

**Replaces.**  ``moe_combine``: the gather, weighting and scatter-add of
the experts' outputs back to the tokens, ``src/repro/models/moe.py:161``
(``_moe_local``; XLA's in the reference, an eager chain of a zero-row
``cat``, an ``index_select``, a cast, a multiply and a sum in the port
before).  ``moe_combine_bwd``: autograd's chain over that combine and the
router's backward (``src/repro/kernels/ops.py:376``, ``router_topk``,
which the reference differentiates with XLA; the port's
``moe_router.router_bwd``), in one launch.  One source,
``csrc/moe_combine.cu``; the logits' row gradient is the same device
function as ``router_bwd``'s (``csrc/moe_router_common.cuh``).

**What bounds them on an H100: bytes.**  At granite-moe-3b-a800m's
training shape (T 1024, k 8, d 1536, E·C 40·256, bf16) the forward moves
28.4 MB (the kept rows of ``out_buf`` read, y written), 0.0085 ms at
3.35 TB/s; the backward 60.4 MB (dy and the kept rows read, every row of
``d_out_buf`` written), 0.018 ms.  A serving call moves well under 1 MB:
launch latency is its floor.

**What the design does about it.**  One launch each where the eager
chain made about 6 (forward) and 8 with ``router_bwd``'s (backward), and
none of the chain's copies (the zero-row ``cat`` of the whole buffer, the
gathered (T, k, d) values, their products): a block a token row, 16-byte
loads of all k rows in flight at once, sums in f32 in choice order.  The
backward writes ``d_out_buf``'s rows and sums dw_j = Σ_d dy·out in the
same block, then runs the router's row function on it: dw never goes to
device memory.  No atomics: a kept slot belongs to exactly one (t, j).
The same inputs give the same outputs on every run.

**Numbers.**  The sums are taken in f32 and rounded once to the compute
dtype.  In f32 that is the chain's arithmetic (to the order of a sum).
In bf16 the chain rounded each product ``vals * w`` to bf16, with ``w``
cast to bf16, before the sum, and its dw was a bf16 sum: y, ``d_out_buf``
and dw each drop those roundings now.

The slot count is ``out_buf``'s rows: an expert shard passes its e_local·C
slots and the routing's slots for that range (``router_dispatch`` with
``e_start``/``e_local``), where a choice outside the shard carries the
sentinel e_local·C and so reads as dropped.

``moe_combine`` and ``moe_combine_bwd`` dispatch on the device of their
rows: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.  There is no fallback; every check comes before the
library is built or bound.  ``moe_combine.launches`` and
``moe_combine_bwd.launches`` count launches.  A fake tensor (the dry
run's) takes the card's branch up to the launch, as ``kernels/cost.py``
says.  ``CombineFunction`` is the
MoE layer's combine with a gradient: ``moe_combine`` forward,
``moe_combine_bwd`` backward, the aux sums passed through so that their
gradients reach it.
"""
from __future__ import annotations

import ctypes

import torch

from . import cost

from .moe_router import MAX_EXPERTS, MAX_K, router_bwd_plain

DTYPES = (torch.float32, torch.bfloat16)


def moe_combine_plain(out_buf, w, slot) -> torch.Tensor:
    """y (T, d) = Σ_j w[t, j] · out_buf[slot[t, j]] over token t's kept
    choices (slot < E·C), summed in f32 and rounded once to
    ``out_buf``'s dtype; a dropped choice contributes nothing."""
    n_slots = out_buf.shape[0]
    keep = slot < n_slots
    at = torch.where(keep, slot, 0).long()
    vals = out_buf.float().index_select(0, at.view(-1)).view(
        *slot.shape, -1)
    contrib = torch.where(keep[..., None], vals * w.float()[..., None], 0.0)
    return contrib.sum(1).to(out_buf.dtype)


def moe_combine_bwd_plain(dy, out_buf, logits, probs, idx, w, slot, src,
                          dprob_sum, dz_sum, *, n_real: int):
    """(d_out_buf (E·C, d) in ``out_buf``'s dtype, dlogits (T, E) f32):
    the slot row of (t, j) is w[t, j]·dy[t] and a slot whose ``src`` is T
    is 0; dw_j = Σ_d dy[t]·out_buf[slot[t, j]] in f32 (0 for a dropped
    j) goes through ``router_bwd_plain`` with ``dprob_sum`` and ``dz_sum``
    (None for zero).  ``src`` is the kernel's (which rows to zero): here
    every row starts at zero."""
    T, k = slot.shape
    n_slots, d = out_buf.shape
    keep = slot < n_slots
    at = torch.where(keep, slot, 0).long()
    g = dy.float()
    vals = out_buf.float().index_select(0, at.view(-1)).view(T, k, d)
    dw = torch.where(keep, (vals * g[:, None, :]).sum(-1), 0.0)
    dlogits = router_bwd_plain(logits, probs, idx, w, dw, dprob_sum, dz_sum,
                               n_real=n_real)
    # the dropped choices all land on one extra row, cut off after
    rows = (w.float()[..., None] * g[:, None, :]).view(T * k, d)
    d_out = torch.zeros((n_slots + 1, d), dtype=torch.float32,
                        device=dy.device)
    d_out.index_copy_(0, torch.where(keep, slot, n_slots).long().view(-1),
                      rows)
    return d_out[:n_slots].to(out_buf.dtype), dlogits


def moe_combine(out_buf, w, slot) -> torch.Tensor:
    """``moe_combine_plain`` on the CPU, the combine kernel on the card;
    no fallback."""
    if cost.route(out_buf, "moe_combine") == "plain":
        return moe_combine_plain(out_buf, w, slot)
    return _moe_combine_cuda(out_buf, w, slot)


moe_combine.launches = 0


def moe_combine_bwd(dy, out_buf, logits, probs, idx, w, slot, src,
                    dprob_sum, dz_sum, *, n_real: int):
    """``moe_combine_bwd_plain`` on the CPU, the backward kernel on the
    card; no fallback."""
    if cost.route(out_buf, "moe_combine_bwd") == "plain":
        return moe_combine_bwd_plain(dy, out_buf, logits, probs, idx, w,
                                     slot, src, dprob_sum, dz_sum,
                                     n_real=n_real)
    return _moe_combine_bwd_cuda(dy, out_buf, logits, probs, idx, w, slot,
                                 src, dprob_sum, dz_sum, n_real=n_real)


moe_combine_bwd.launches = 0


class CombineFunction(torch.autograd.Function):
    """The MoE layer's combine with the router's gradient: ``y`` from
    ``out_buf`` (E·C, d) and the routing by ``moe_combine``, and
    ``prob_sum`` and ``z_sum`` passed through; the backward takes the
    gradients of all three to ``logits`` and ``out_buf`` in one
    ``moe_combine_bwd``.  The routing (computed on detached logits) is
    saved, not differentiated."""

    @staticmethod
    def forward(ctx, logits, out_buf, probs, idx, w, slot, src, prob_sum,
                z_sum, n_real):
        ctx.n_real = n_real
        ctx.save_for_backward(out_buf, logits, probs, idx, w, slot, src)
        ctx.set_materialize_grads(False)
        return moe_combine(out_buf, w, slot), prob_sum, z_sum

    @staticmethod
    def backward(ctx, dy, dprob_sum, dz_sum):
        out_buf, logits, probs, idx, w, slot, src = ctx.saved_tensors
        if dy is None:
            dy = out_buf.new_zeros((slot.shape[0], out_buf.shape[1]))
        d_out, dlogits = moe_combine_bwd(dy, out_buf, logits, probs, idx, w,
                                         slot, src, dprob_sum, dz_sum,
                                         n_real=ctx.n_real)
        return (dlogits, d_out) + (None,) * 8


_fn = None   # the C entries, bound once by _kernel() / _bwd_kernel()
_bwd_fn = None


def _kernel():
    """The combine's C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("moe_combine").repro_moe_combine
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _bwd_kernel():
    """The backward's C entry, bound at its first launch."""
    global _bwd_fn
    if _bwd_fn is None:
        from .build import load
        fn = load("moe_combine").repro_moe_combine_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        _bwd_fn = fn
    return _bwd_fn


def _check_rows(name, out_buf, w, slot):
    """(T, k, E·C, d) of a combine's rows and routing, or raises."""
    if out_buf.ndim != 2 or out_buf.dtype not in DTYPES:
        raise ValueError(f"{name}: out_buf must be (E*C, d) float32 or "
                         f"bfloat16, got {tuple(out_buf.shape)} "
                         f"{out_buf.dtype}")
    if slot.ndim != 2 or w.shape != slot.shape:
        raise ValueError(f"{name}: w {tuple(w.shape)} and slot "
                         f"{tuple(slot.shape)} must be one (T, k)")
    if slot.dtype != torch.int32 or w.dtype != torch.float32:
        raise ValueError(f"{name}: slot must be int32 and w float32, got "
                         f"{slot.dtype}, {w.dtype}")
    T, k = slot.shape
    n_slots, d = out_buf.shape
    if T < 1 or d < 1 or n_slots < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: needs T, d, E*C >= 1 and 1 <= k <= "
                         f"{MAX_K}; got T={T}, d={d}, E*C={n_slots}, k={k}")
    if n_slots * d >= 2 ** 31 or T * d >= 2 ** 31:
        raise ValueError(f"{name}: rows of {n_slots} x {d} exceed the "
                         f"kernel's int indexing")
    return T, k, n_slots, d


def _ptr(t):
    return None if t is None else t.data_ptr()


def _moe_combine_cuda(out_buf, w, slot) -> torch.Tensor:
    """Validate, then launch ``combine_kernel``: a block a token row.
    Every check comes before the kernel is built or bound."""
    T, k, n_slots, d = _check_rows("moe_combine", out_buf, w, slot)
    if not (out_buf.device == w.device == slot.device):
        raise ValueError("moe_combine: every input must be on one device")
    out_buf, w, slot = (t.contiguous() for t in (out_buf, w, slot))
    y = torch.empty((T, d), dtype=out_buf.dtype, device=out_buf.device)
    if cost.is_fake(out_buf):
        cost.add("moe_combine", *cost.combine_work(
            n_slots, d, T, k, out_buf.element_size(),
            cost.combine_kept(slot, n_slots)))
        return y
    fn = _kernel()
    with torch.cuda.device(out_buf.device):
        stream = torch.cuda.current_stream(out_buf.device).cuda_stream
        err = fn(out_buf.data_ptr(), w.data_ptr(), slot.data_ptr(),
                 y.data_ptr(), T, d, k, n_slots,
                 int(out_buf.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"moe_combine kernel launch failed: CUDA error "
                           f"{err}")
    moe_combine.launches += 1
    return y


def _moe_combine_bwd_cuda(dy, out_buf, logits, probs, idx, w, slot, src,
                          dprob_sum, dz_sum, *, n_real: int):
    """Validate, then launch ``combine_bwd_kernel``: a block a token row,
    then blocks that zero the empty slot rows.  A gradient that is None
    reads as zero (a null pointer)."""
    T, k, n_slots, d = _check_rows("moe_combine_bwd", out_buf, w, slot)
    if dy.shape != (T, d) or dy.dtype != out_buf.dtype:
        raise ValueError(f"moe_combine_bwd: dy must be ({T}, {d}) "
                         f"{out_buf.dtype}, got {tuple(dy.shape)} "
                         f"{dy.dtype}")
    if logits.ndim != 2 or logits.shape[0] != T or \
            probs.shape != logits.shape:
        raise ValueError(f"moe_combine_bwd: logits {tuple(logits.shape)} "
                         f"and probs {tuple(probs.shape)} must be one "
                         f"({T}, E)")
    E = logits.shape[1]
    if idx.shape != (T, k) or idx.dtype != torch.int32:
        raise ValueError(f"moe_combine_bwd: idx must be ({T}, {k}) int32, "
                         f"got {tuple(idx.shape)} {idx.dtype}")
    if src.shape != (n_slots,) or src.dtype != torch.int32:
        raise ValueError(f"moe_combine_bwd: src must be ({n_slots},) "
                         f"int32, got {tuple(src.shape)} {src.dtype}")
    if not (k <= E <= MAX_EXPERTS and 1 <= n_real <= E):
        raise ValueError(f"moe_combine_bwd: needs k <= E <= {MAX_EXPERTS} "
                         f"and 1 <= n_real <= E; got k={k}, E={E}, "
                         f"n_real={n_real}")
    if (dprob_sum is not None and dprob_sum.shape != (E,)) or \
            (dz_sum is not None and dz_sum.numel() != 1):
        raise ValueError("moe_combine_bwd: dprob_sum must be (E,), dz_sum "
                         "one value")
    dev = out_buf.device
    ts = [dy, out_buf, logits, probs, idx, w, slot, src] + [
        t for t in (dprob_sum, dz_sum) if t is not None]
    if any(t.device != dev for t in ts):
        raise ValueError("moe_combine_bwd: every input must be on one "
                         "device")

    def f32(t):
        return None if t is None else t.float().contiguous()
    logits, probs, w, dprob_sum, dz_sum = map(
        f32, (logits, probs, w, dprob_sum, dz_sum))
    dy, out_buf, idx, slot, src = (t.contiguous() for t in
                                   (dy, out_buf, idx, slot, src))
    d_out = torch.empty_like(out_buf)
    dlogits = torch.empty((T, E), dtype=torch.float32, device=dev)
    if cost.is_fake(out_buf):
        cost.add("moe_combine_bwd", *cost.combine_bwd_work(
            n_slots, d, T, k, E, out_buf.element_size(),
            cost.combine_kept(slot, n_slots)))
        return d_out, dlogits
    fn = _bwd_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(dy), _ptr(out_buf), _ptr(logits), _ptr(probs),
                 _ptr(idx), _ptr(w), _ptr(slot), _ptr(src), _ptr(dprob_sum),
                 _ptr(dz_sum), _ptr(d_out), _ptr(dlogits), T, d, E, k,
                 n_real, n_slots, int(out_buf.dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"moe_combine backward launch failed: CUDA "
                           f"error {err}")
    moe_combine_bwd.launches += 1
    return d_out, dlogits
