"""MoE routing and dispatch: the hand-written Hopper kernel and its plain
version.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/moe_router.py``
(``router_topk_pallas``, body ``_kernel``), which ``ops.router_topk``
resolves to on a TPU: every MoE layer of every prefill, chunk and decode
step runs it.  The kernel also takes over the dispatch bookkeeping that
``src/repro/models/moe.py`` (``_moe_local``) leaves to XLA around it:
each assignment's capacity slot, each slot's token, and the aux sums.
One kernel, ``csrc/moe_router.cu``.

**What bounds it on an H100.**  At serving shapes (T = 4 to 64 tokens,
E = 40 experts, k = 8) a call moves a few KB: launch latency, not bytes
or operations, is its floor.

**What the design does about it.**  One launch a MoE layer call, with
fixed-shape outputs and no host sync: one block walks the tokens in
tiles of rows, a warp a row up to 32 tokens and a half-warp a row beyond
(64-row tiles, where E <= 128 and k <= 16), the rows' softmax, k rounds
of argmax with ties to the lowest index (as the Pallas kernel's
``min(where(hit, iota, E))``) and renormalisation taken by lane
shuffles; and each pick's position in its expert comes from a running
count and a per-expert bitmask of the tile's rows in shared memory.  The
aux sums are taken in a fixed order in f64, so the same inputs give the
same sums on every run.

``router_dispatch`` and ``router_topk`` dispatch on the device of
``logits``: a CPU tensor takes the plain version, a CUDA tensor launches
the kernel or raises.  There is no fallback.  ``router_dispatch.launches``
counts kernel launches (``router_topk`` launches the same kernel).  A
fake tensor (the dry run's) takes the card's branch up to the launch: it
allocates what the launch would and adds the call's work to the dry
run's tally (``kernels/cost.py``).

**The backward** (training; the reference differentiates
``ref.router_topk_ref`` and the aux sums with XLA, there is no Pallas
backward).  When ``logits`` needs a gradient, ``router_dispatch`` goes
through :class:`RouterFunction`: the same forward, and a backward that
takes the gradients of ``w``, ``prob_sum`` and ``z_sum`` (the dispatch
outputs and ``probs`` carry none, as the reference's one-hot load
carries none) back to the logits: :func:`router_bwd`, the second kernel
of ``csrc/moe_router.cu`` (``router_bwd_kernel``, a warp a token row, no
atomics), or :func:`router_bwd_plain` on the CPU.  At training's T 1024,
E 40 it moves about 0.5 MB: launch latency is its floor too.
``router_bwd.launches`` counts its launches.  The MoE layer does not
launch it: it routes on detached logits and takes their gradient from
the MoE combine's backward (``moe_combine.py``), which runs the same
row function (``csrc/moe_router_common.cuh``) in its own launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import cost

MAX_EXPERTS = 512
MAX_K = 32
NEG_INF = -1e30      # a padded expert's logit, as the reference masks it


class Routing(NamedTuple):
    """What one MoE layer call's routing decides, in fixed shapes.
    Assignment (t, j) is token t's j-th choice; C is the capacity."""
    w: torch.Tensor         # (T, k) f32, renormalised weights
    idx: torch.Tensor       # (T, k) int32, chosen experts
    probs: torch.Tensor     # (T, E) f32, softmax over the masked logits
    slot: torch.Tensor      # (T, k) int32, e*C + position, E*C if dropped
    src: torch.Tensor       # (E*C,) int32, each slot's token, T if empty
    # (with an expert range [e_start, e_start + e_local): slot
    # (e - e_start)*C + position for the range's experts and e_local*C for
    # every other assignment, src (e_local*C,))
    load: torch.Tensor      # (E,) f32, assignments per expert (dropped too)
    prob_sum: torch.Tensor  # (E,) f32, sum over tokens of probs
    z_sum: torch.Tensor     # () f32, sum over tokens of logsumexp²


def router_topk_plain(logits, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k softmax gating, as ``ref.router_topk_ref``: logits (T, E) →
    (weights (T,k) f32 renormalized by max(sum, 1e-9), idx (T,k) int32,
    probs (T,E) f32).  A stable descending sort gives ``lax.top_k``'s
    order: equal probabilities in ascending expert index."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx.to(torch.int32), probs


def dispatch_plain(idx, n_experts: int, capacity: int,
                   dispatch: str = "sort", e_start: int = 0,
                   e_local: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slot, src, load) of the assignments ``idx`` (T, k), as the
    reference's dispatch computes positions: by a stable sort over
    experts (``"sort"``) or a running count over the one-hot
    (``"cumsum"``); both rank an assignment among the earlier ones to
    the same expert in (t, j) order.  Positions at or past ``capacity``
    are dropped, and so is every assignment to an expert outside
    ``[e_start, e_start + e_local)`` (default all ``n_experts``): the
    reference's ``keep = (pos_in_e < C) & in_shard``.  Positions and
    ``load`` count over all experts.  Fixed shapes: no boolean
    indexing."""
    T, k = idx.shape
    dev = idx.device
    n = T * k
    flat_e = idx.reshape(-1).long()
    experts = torch.arange(n_experts, device=dev)
    onehot = flat_e[:, None] == experts[None, :]                # (T*k, E)
    if dispatch == "cumsum":
        ohf = onehot.float()
        prior = torch.cumsum(ohf, dim=0) - ohf
        pos = (prior * ohf).sum(1).long()
    else:
        order = torch.argsort(flat_e, stable=True)
        se = flat_e[order]
        seg_start = torch.searchsorted(se, experts)
        pos = torch.empty_like(order).scatter_(
            0, order, torch.arange(n, device=dev) - seg_start[se])
    e_local = n_experts if e_local is None else e_local
    n_slots = e_local * capacity
    local = flat_e - e_start
    keep = (pos < capacity) & (local >= 0) & (local < e_local)
    slot = torch.where(keep, local * capacity + pos, n_slots)
    # dropped assignments all land on one extra element, cut off after
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=dev)
    src.scatter_(0, slot, torch.arange(n, device=dev) // k)
    load = onehot.sum(0).float()
    return (slot.view(T, k).to(torch.int32), src[:n_slots].to(torch.int32),
            load)


def router_dispatch_plain(logits, k: int, *, n_real: int, capacity: int,
                          dispatch: str = "sort", e_start: int = 0,
                          e_local: Optional[int] = None) -> Routing:
    """Routing of one MoE layer call, as ``models/moe.py`` computed it
    around ``router_topk``: experts at or past ``n_real`` masked to
    -1e30, top-k softmax gating, ``dispatch_plain`` (to the expert range
    ``[e_start, e_start + e_local)``, default all) and the aux sums, which
    cover all experts."""
    logits = logits.float()
    E = logits.shape[1]
    if n_real < E:
        pad = torch.arange(E, device=logits.device) >= n_real
        logits = logits.masked_fill(pad[None], NEG_INF)
    w, idx, probs = router_topk_plain(logits, k)
    slot, src, load = dispatch_plain(idx, E, capacity, dispatch, e_start,
                                     e_local)
    z_sum = torch.square(torch.logsumexp(logits, dim=-1)).sum()
    return Routing(w, idx, probs, slot, src, load, probs.sum(0), z_sum)


def router_bwd_plain(logits, probs, idx, w, dw, dprob_sum, dz_sum, *,
                     n_real: int) -> torch.Tensor:
    """The gradient of the logits (T, E) f32, from the gradients of the
    routing's differentiable outputs: ``dw`` (T, k), ``dprob_sum`` (E,)
    and ``dz_sum`` () (None for zero).  With p the row's probabilities,
    wsum = Σ_j p[idx_j] and w_j = p[idx_j] / max(wsum, 1e-9):

        dp[e] = dprob_sum[e] + Σ_{j: idx_j = e} g_j,
        g_j = (dw_j − Σ_i dw_i·w_i) / wsum   (dw_j / 1e-9 when clamped),
        dlogit[e] = p[e]·(dp[e] − Σ_e' p[e']·dp[e']) + 2·dz_sum·lse·p[e],

    lse recomputed from the masked logits.  Experts at or past
    ``n_real`` get 0 (the forward's mask)."""
    T, E = logits.shape
    x = logits.float()
    pad = torch.arange(E, device=x.device) >= n_real
    if n_real < E:
        x = x.masked_fill(pad[None], NEG_INF)
    lse = torch.logsumexp(x, dim=-1)                               # (T,)
    idx = idx.long()
    wsum = torch.gather(probs, 1, idx).sum(-1, keepdim=True)        # (T,1)
    dw = torch.zeros_like(w) if dw is None else dw.float()
    clamped = wsum <= 1e-9
    g = torch.where(clamped, dw / 1e-9,
                    (dw - (dw * w).sum(-1, keepdim=True))
                    / torch.clamp(wsum, min=1e-9))
    dp = torch.zeros_like(probs).scatter_add_(1, idx, g)
    if dprob_sum is not None:
        dp = dp + dprob_sum.float()[None]
    dlogit = probs * (dp - (probs * dp).sum(-1, keepdim=True))
    if dz_sum is not None:
        dlogit = dlogit + (2.0 * dz_sum.float()) * lse[:, None] * probs
    return dlogit.masked_fill(pad[None], 0.0)


def router_bwd(logits, probs, idx, w, dw, dprob_sum, dz_sum, *,
               n_real: int) -> torch.Tensor:
    """``router_bwd_plain`` on the CPU, the backward kernel on the card;
    no fallback."""
    if logits.device.type == "cpu":
        return router_bwd_plain(logits, probs, idx, w, dw, dprob_sum,
                                dz_sum, n_real=n_real)
    if logits.device.type != "cuda":
        raise ValueError(f"router_bwd: no kernel for device "
                         f"{logits.device}")
    return _router_bwd_cuda(logits, probs, idx, w, dw, dprob_sum, dz_sum,
                            n_real=n_real)


router_bwd.launches = 0


class RouterFunction(torch.autograd.Function):
    """Routing and dispatch with the logits' gradient: the forward of
    ``router_dispatch`` (kernel or plain, by device), ``router_bwd``
    backward.  Outputs in ``Routing`` order; ``w``, ``prob_sum`` and
    ``z_sum`` carry gradients, the rest are marked non-differentiable."""

    @staticmethod
    def forward(ctx, logits, k, n_real, capacity, dispatch, e_start,
                e_local):
        r = _route(logits, k, n_real=n_real, capacity=capacity,
                   dispatch=dispatch, e_start=e_start, e_local=e_local)
        ctx.n_real = n_real
        ctx.save_for_backward(logits, r.probs, r.idx, r.w)
        ctx.mark_non_differentiable(r.idx, r.probs, r.slot, r.src, r.load)
        ctx.set_materialize_grads(False)
        return tuple(r)

    @staticmethod
    def backward(ctx, dw, _idx, _probs, _slot, _src, _load, dprob_sum,
                 dz_sum):
        logits, probs, idx, w = ctx.saved_tensors
        if dw is None and dprob_sum is None and dz_sum is None:
            return (None,) * 7
        dlogits = router_bwd(logits, probs, idx, w, dw, dprob_sum, dz_sum,
                             n_real=ctx.n_real)
        return (dlogits,) + (None,) * 6


def _route(logits, k, *, n_real, capacity, dispatch, e_start=0,
           e_local=None) -> Routing:
    """The forward by device: the plain version or the kernel."""
    kw = dict(n_real=n_real, capacity=capacity, e_start=e_start,
              e_local=e_local)
    if cost.route(logits, "router_dispatch") == "plain":
        return router_dispatch_plain(logits, k, dispatch=dispatch, **kw)
    return _router_dispatch_cuda(logits, k, **kw)


def router_dispatch(logits, k: int, *, n_real: int, capacity: int,
                    dispatch: str = "sort", e_start: int = 0,
                    e_local: Optional[int] = None) -> Routing:
    """Routing and dispatch of one MoE layer call; see
    ``router_dispatch_plain``.  The kernel takes both dispatch forms'
    positions from one running count: they agree.  An expert shard passes
    its range ``[e_start, e_start + e_local)``: routing and the aux sums
    stay over all experts, and only the range's assignments get slots.
    Logits that need a gradient go through ``RouterFunction``."""
    if torch.is_grad_enabled() and logits.requires_grad:
        return Routing(*RouterFunction.apply(logits, k, n_real, capacity,
                                             dispatch, e_start, e_local))
    return _route(logits, k, n_real=n_real, capacity=capacity,
                  dispatch=dispatch, e_start=e_start, e_local=e_local)


router_dispatch.launches = 0


def router_topk(logits, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights, idx, probs) of the top-k softmax router; see
    ``router_topk_plain``.  On the card it is ``router_dispatch`` with
    every expert real and a capacity of T."""
    if logits.device.type == "cpu":
        return router_topk_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"router_topk: no kernel for device "
                         f"{logits.device}")
    T, E = logits.shape
    return _router_dispatch_cuda(logits, k, n_real=E, capacity=T)[:3]


_fn = None   # the C entries, bound once by _kernel() / _bwd_kernel()
_bwd_fn = None


def _kernel():
    """The kernel's C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("moe_router").repro_router_dispatch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _bwd_kernel():
    """The backward's C entry, bound at its first launch."""
    global _bwd_fn
    if _bwd_fn is None:
        from .build import load
        fn = load("moe_router").repro_router_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        _bwd_fn = fn
    return _bwd_fn


def _router_dispatch_cuda(logits, k: int, *, n_real: int, capacity: int,
                          e_start: int = 0,
                          e_local: Optional[int] = None) -> Routing:
    """Validate, then launch.  Every check comes before the kernel is
    built or bound."""
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError("router_dispatch: this raw launch has no "
                           "backward; logits that need a gradient go "
                           "through router_dispatch(), whose "
                           "RouterFunction carries it")
    if logits.ndim != 2:
        raise ValueError(f"router_dispatch: logits must be (T, E), got "
                         f"{tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise ValueError(f"router_dispatch: the kernel takes f32 logits, "
                         f"got {logits.dtype}")
    T, E = logits.shape
    k, n_real, capacity = int(k), int(n_real), int(capacity)
    if not (1 <= k <= min(E, MAX_K)) or E > MAX_EXPERTS:
        raise ValueError(f"router_dispatch: the kernel takes 1 <= k <= "
                         f"min(E, {MAX_K}) and E <= {MAX_EXPERTS}; got "
                         f"k={k}, E={E}")
    if not (1 <= n_real <= E) or capacity < 1 or E * capacity >= 2 ** 31:
        raise ValueError(f"router_dispatch: needs 1 <= n_real <= E and "
                         f"1 <= E*capacity < 2^31; got n_real={n_real}, "
                         f"E={E}, capacity={capacity}")
    e_start = int(e_start)
    e_local = E if e_local is None else int(e_local)
    if not (0 <= e_start and 1 <= e_local and e_start + e_local <= E):
        raise ValueError(f"router_dispatch: the expert range [{e_start}, "
                         f"{e_start}+{e_local}) is not within E={E}")
    if T < 1:
        raise ValueError("router_dispatch: no tokens")
    logits = logits.contiguous()
    dev = logits.device

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    r = Routing(w=out(T, k), idx=out(T, k, dtype=torch.int32),
                probs=out(T, E), slot=out(T, k, dtype=torch.int32),
                src=out(e_local * capacity, dtype=torch.int32), load=out(E),
                prob_sum=out(E), z_sum=out())
    if cost.is_fake(logits):
        cost.add("moe_router", *cost.router_work(T, E, k, e_local,
                                                 capacity))
        return r
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(logits.data_ptr(), *(t.data_ptr() for t in r), T, E, k,
                 n_real, capacity, e_start, e_local, stream)
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{err}")
    router_dispatch.launches += 1
    return r


def _router_bwd_cuda(logits, probs, idx, w, dw, dprob_sum, dz_sum, *,
                     n_real: int) -> torch.Tensor:
    """Validate, then launch ``router_bwd_kernel``: a warp a token row.
    A gradient that is None reads as zero (a null pointer)."""
    if logits.ndim != 2 or probs.shape != logits.shape:
        raise ValueError(f"router_bwd: logits {tuple(logits.shape)} and "
                         f"probs {tuple(probs.shape)} must be one (T, E)")
    T, E = logits.shape
    k = idx.shape[1] if idx.ndim == 2 else -1
    if idx.shape != (T, k) or w.shape != (T, k) or \
            (dw is not None and dw.shape != (T, k)):
        raise ValueError(f"router_bwd: idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)} must be ({T}, k)")
    if not (1 <= k <= min(E, MAX_K)) or E > MAX_EXPERTS or \
            not (1 <= n_real <= E):
        raise ValueError(f"router_bwd: needs 1 <= k <= min(E, {MAX_K}), "
                         f"E <= {MAX_EXPERTS}, 1 <= n_real <= E; got k={k},"
                         f" E={E}, n_real={n_real}")
    if (dprob_sum is not None and dprob_sum.shape != (E,)) or \
            (dz_sum is not None and dz_sum.numel() != 1):
        raise ValueError("router_bwd: dprob_sum must be (E,), dz_sum one "
                         "value")
    if idx.dtype != torch.int32:
        raise ValueError(f"router_bwd: idx must be int32, got {idx.dtype}")
    dev = logits.device
    ts = [logits, probs, idx, w] + [t for t in (dw, dprob_sum, dz_sum)
                                    if t is not None]
    if any(t.device != dev for t in ts):
        raise ValueError("router_bwd: every input must be on one device")

    def f32(t):
        return None if t is None else t.float().contiguous()
    logits, probs, w, dw, dprob_sum, dz_sum = map(
        f32, (logits, probs, w, dw, dprob_sum, dz_sum))
    idx = idx.contiguous()
    dlogits = torch.empty((T, E), dtype=torch.float32, device=dev)
    fn = _bwd_kernel()

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(logits), ptr(probs), ptr(idx), ptr(w), ptr(dw),
                 ptr(dprob_sum), ptr(dz_sum), ptr(dlogits), T, E, k,
                 n_real, stream)
    if err != 0:
        raise RuntimeError(f"moe_router backward launch failed: CUDA error "
                           f"{err}")
    router_bwd.launches += 1
    return dlogits
