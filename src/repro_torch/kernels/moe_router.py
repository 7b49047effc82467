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
counts kernel launches (``router_topk`` launches the same kernel).  The
kernel has no backward: on the card it refuses logits that need a
gradient.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

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
                   dispatch: str = "sort"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(slot, src, load) of the assignments ``idx`` (T, k), as the
    reference's dispatch computes positions: by a stable sort over
    experts (``"sort"``) or a running count over the one-hot
    (``"cumsum"``); both rank an assignment among the earlier ones to
    the same expert in (t, j) order.  Positions at or past ``capacity``
    are dropped.  Fixed shapes: no boolean indexing."""
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
    n_slots = n_experts * capacity
    slot = torch.where(pos < capacity, flat_e * capacity + pos, n_slots)
    # dropped assignments all land on one extra element, cut off after
    src = torch.full((n_slots + 1,), T, dtype=torch.long, device=dev)
    src.scatter_(0, slot, torch.arange(n, device=dev) // k)
    load = onehot.sum(0).float()
    return (slot.view(T, k).to(torch.int32), src[:n_slots].to(torch.int32),
            load)


def router_dispatch_plain(logits, k: int, *, n_real: int, capacity: int,
                          dispatch: str = "sort") -> Routing:
    """Routing of one MoE layer call, as ``models/moe.py`` computed it
    around ``router_topk``: experts at or past ``n_real`` masked to
    -1e30, top-k softmax gating, ``dispatch_plain`` and the aux sums."""
    logits = logits.float()
    E = logits.shape[1]
    if n_real < E:
        pad = torch.arange(E, device=logits.device) >= n_real
        logits = logits.masked_fill(pad[None], NEG_INF)
    w, idx, probs = router_topk_plain(logits, k)
    slot, src, load = dispatch_plain(idx, E, capacity, dispatch)
    z_sum = torch.square(torch.logsumexp(logits, dim=-1)).sum()
    return Routing(w, idx, probs, slot, src, load, probs.sum(0), z_sum)


def router_dispatch(logits, k: int, *, n_real: int, capacity: int,
                    dispatch: str = "sort") -> Routing:
    """Routing and dispatch of one MoE layer call; see
    ``router_dispatch_plain``.  The kernel takes both dispatch forms'
    positions from one running count: they agree."""
    if logits.device.type == "cpu":
        return router_dispatch_plain(logits, k, n_real=n_real,
                                     capacity=capacity, dispatch=dispatch)
    if logits.device.type != "cuda":
        raise ValueError(f"router_dispatch: no kernel for device "
                         f"{logits.device}")
    return _router_dispatch_cuda(logits, k, n_real=n_real, capacity=capacity)


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


_fn = None   # the C entry, bound once by _kernel()


def _kernel():
    """The kernel's C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("moe_router").repro_router_dispatch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _router_dispatch_cuda(logits, k: int, *, n_real: int,
                          capacity: int) -> Routing:
    """Validate, then launch.  Every check comes before the kernel is
    built or bound."""
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError("router_dispatch: the kernel has no backward "
                           "(ROADMAP A9b); logits that need a gradient "
                           "would get none")
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
    if T < 1:
        raise ValueError("router_dispatch: no tokens")
    logits = logits.contiguous()
    dev = logits.device

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)
    r = Routing(w=out(T, k), idx=out(T, k, dtype=torch.int32),
                probs=out(T, E), slot=out(T, k, dtype=torch.int32),
                src=out(E * capacity, dtype=torch.int32), load=out(E),
                prob_sum=out(E), z_sum=out())
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(logits.data_ptr(), *(t.data_ptr() for t in r), T, E, k,
                 n_real, capacity, stream)
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{err}")
    router_dispatch.launches += 1
    return r
