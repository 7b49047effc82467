"""MoE router top-k: the hand-written Hopper kernel and its plain version.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/moe_router.py``
(``router_topk_pallas``, body ``_kernel``), which ``ops.router_topk``
resolves to on a TPU: every MoE layer of every prefill, chunk and decode
step runs it.  One kernel, ``csrc/moe_router.cu``.

**What bounds it on an H100.**  At serving shapes (T = 4 to 64 tokens,
E = 40 experts, k = 8) a call moves a few KB: launch latency, not bytes
or operations, is its floor.

**What the design does about it.**  One launch per call and nothing
staged: a warp owns a token row, its lanes hold the row's logits in
registers, and softmax, the k rounds of argmax (ties to the lowest
index, as the Pallas kernel's ``min(where(hit, iota, E))``) and the
renormalisation are warp shuffles.

``router_topk`` dispatches on the device of ``logits``: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
There is no fallback.  ``router_topk.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

MAX_EXPERTS = 512
MAX_K = 32


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


def router_topk(logits, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights, idx, probs) of the top-k softmax router; see
    ``router_topk_plain``."""
    if logits.device.type == "cpu":
        return router_topk_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"router_topk: no kernel for device "
                         f"{logits.device}")
    return _router_topk_cuda(logits, k)


router_topk.launches = 0

_fn = None   # the C entry, bound once by _kernel()


def _kernel():
    """The kernel's C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("moe_router").repro_router_topk
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _router_topk_cuda(logits, k: int):
    if logits.ndim != 2:
        raise ValueError(f"router_topk: logits must be (T, E), got "
                         f"{tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise ValueError(f"router_topk: the kernel takes f32 logits, got "
                         f"{logits.dtype}")
    T, E = logits.shape
    k = int(k)
    if not (1 <= k <= min(E, MAX_K)) or E > MAX_EXPERTS:
        raise ValueError(f"router_topk: the kernel takes 1 <= k <= min(E, "
                         f"{MAX_K}) and E <= {MAX_EXPERTS}; got k={k}, "
                         f"E={E}")
    logits = logits.contiguous()
    dev = logits.device
    w = torch.empty((T, k), dtype=torch.float32, device=dev)
    idx = torch.empty((T, k), dtype=torch.int32, device=dev)
    probs = torch.empty((T, E), dtype=torch.float32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(logits.data_ptr(), w.data_ptr(), idx.data_ptr(),
                 probs.data_ptr(), T, E, k, stream)
    if err != 0:
        raise RuntimeError(f"moe_router kernel launch failed: CUDA error "
                           f"{err}")
    router_topk.launches += 1
    return w, idx, probs
