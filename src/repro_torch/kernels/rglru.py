"""RG-LRU (Griffin / recurrentgemma) recurrence: the hand-written Hopper
kernels, their plain versions and the one-token decode step.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/rglru_scan.py``
(``rglru_pallas``, body ``_kernel``), which ``ops.rglru`` resolves to on a
TPU: every RG-LRU layer's prefill runs it.  Kernels in
``csrc/rglru_scan.cu``.  Decode does not launch them: the reference's
decode step is ``ops.rglru_decode_step`` outside any Pallas kernel, and
:func:`rglru_decode_step` here is plain torch too.

Per channel, with the gates given before their sigmoid::

    r, i = σ(r_gate), σ(i_gate)
    log a = −8·softplus(Λ)·r,   β = √max(1 − exp(2·log a), 1e-12)
    hₜ = aₜ·hₜ₋₁ + β·i·xₜ

**What bounds it on an H100.**  Three reads and one write per element
and a dozen operations: bound by bytes.  Channels are independent and
time is a chain of (a, b) pairs, which compose associatively.

**What the design does about it.**  Time is cut into chunks of
``CHUNK`` steps and each (row, chunk, channel) is a thread, so that
prefill's batch of 1 puts tens of warps on every SM: ``rglru_chunk_summary`` runs
each chunk from h = 0 and writes its pair (A_c = Π aₜ, end state e_c);
``rglru_chunk_apply`` folds the pairs of the chunks before its own into
the entering state from h0 and runs its chunk again from there, writing
hₜ.  x and the gates are read twice: 7/4 of the bytes bound.  A sequence
of one chunk launches the second pass alone.  bf16 takes two channels a
thread.  Their plain counterparts, held against :func:`rglru_plain` on
the CPU: :func:`rglru_chunk_summary_plain`, :func:`rglru_chunk_apply_plain`.

**Rounding of the reassociation.**  The entering state is multiplied by
the chunk's product A_c where the sequential form multiplies by each aₜ
in turn, and the chunk's own part e_c is summed from zero.

``rglru`` dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernels or raises.  There is no
fallback.  ``rglru.launches`` counts calls (one per layer's prefill) that
launched the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

RGLRU_C = 8.0
# The kernels' chunk length L.  Timed at recurrentgemma-9b's W 4096, B 1,
# S 600-2600 against L 16-256 (tools/scan_tuning.py), 32 was the fastest
# or within a few per cent of it at every S: shorter chunks put more
# warps in flight, longer ones leave fewer pairs to fold.
CHUNK = 32
_DTYPES = (torch.float32, torch.bfloat16)


def _decay(r_gate, log_lambda):
    """(a, β) from the pre-sigmoid gate and Λ, in f32."""
    r = torch.sigmoid(r_gate.float())
    log_a = -RGLRU_C * F.softplus(log_lambda.float()) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return torch.exp(log_a), beta


def rglru_plain(x, r_gate, i_gate, log_lambda, h0=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence of ``ref.rglru_ref``, in f32.

    x, r_gate, i_gate (B,S,W), log_lambda (W,), h0 (B,W) optional →
    (h (B,S,W) in x's dtype, h_final (B,W) f32)."""
    Bb, S, W = x.shape
    a, beta = _decay(r_gate, log_lambda)
    gated = torch.sigmoid(i_gate.float()) * x.float() * beta
    h = (torch.zeros((Bb, W), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = []
    for t in range(S):
        h = a[:, t] * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def _chunked_steps(x, r_gate, i_gate, log_lambda, L: int):
    """a and β·i·x (Bb,nc,L,W) in f32, past S padded with the identity
    step (a = 1, nothing added)."""
    a, beta = _decay(r_gate, log_lambda)
    gated = torch.sigmoid(i_gate.float()) * x.float() * beta
    pad = (-x.shape[1]) % L
    a = F.pad(a, (0, 0, 0, pad), value=1.0)
    gated = F.pad(gated, (0, 0, 0, pad))
    Bb, W = x.shape[0], x.shape[2]
    return a.reshape(Bb, -1, L, W), gated.reshape(Bb, -1, L, W)


def rglru_chunk_summary_plain(x, r_gate, i_gate, log_lambda, *,
                              chunk: int = CHUNK
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's pair, as ``rglru_chunk_summary`` computes it: (A
    (Bb,nc,W) = Π aₜ over the chunk, e (Bb,nc,W) = its end state from
    h = 0), f32."""
    a, gated = _chunked_steps(x, r_gate, i_gate, log_lambda, chunk)
    h = torch.zeros_like(a[:, :, 0])
    prod = torch.ones_like(h)
    for t in range(chunk):
        h = a[:, :, t] * h + gated[:, :, t]
        prod = prod * a[:, :, t]
    return prod, h


def rglru_chunk_apply_plain(x, r_gate, i_gate, log_lambda, A, e, h0=None,
                            *, chunk: int = CHUNK
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second pass, as ``rglru_chunk_apply`` computes it: each chunk's
    entering state folded from h0 (or zero) over the earlier chunks'
    pairs, h_in = A_c·h_in + e_c, then the chunk run from it → (h
    (Bb,S,W) in x's dtype, h_final (Bb,W) f32)."""
    Bb, S, W = x.shape
    a, gated = _chunked_steps(x, r_gate, i_gate, log_lambda, chunk)
    h = (torch.zeros((Bb, W), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    entering = []
    for c in range(a.shape[1]):
        entering.append(h)
        h = A[:, c] * h + e[:, c]
    h = torch.stack(entering, dim=1)
    hs = []
    for t in range(chunk):
        h = a[:, :, t] * h + gated[:, :, t]
        hs.append(h)
    hs = torch.stack(hs, dim=2).reshape(Bb, -1, W)[:, :S]
    return hs.to(x.dtype), hs[:, -1]


def rglru_decode_step(h, x_t, r_gate_t, i_gate_t, log_lambda
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token, as ``ops.rglru_decode_step``: h (B,W), x_t and gates
    (B,W) → (h_new in x_t's dtype, h_new f32)."""
    a, beta = _decay(r_gate_t, log_lambda)
    h_new = a * h.float() + beta * (torch.sigmoid(i_gate_t.float())
                                    * x_t.float())
    return h_new.to(x_t.dtype), h_new


def rglru(x, r_gate, i_gate, log_lambda, h0=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, h_final) of the RG-LRU; see ``rglru_plain``."""
    if x.device.type == "cpu":
        return rglru_plain(x, r_gate, i_gate, log_lambda, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rglru: no kernel for device {x.device}")
    return _rglru_cuda(x, r_gate, i_gate, log_lambda, h0)


rglru.launches = 0

_fn = None   # the C entry, bound once by _kernel()


def _kernel():
    """The kernels' C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("rglru_scan").repro_rglru_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _rglru_cuda(x, r_gate, i_gate, log_lambda, h0, chunk_len=None):
    """One call on the card: one launch if the sequence is one chunk,
    else two.  ``chunk_len`` forces L (tests and the smoke run only);
    None takes ``CHUNK``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, r_gate, i_gate, log_lambda, h0)):
        raise RuntimeError("rglru: the kernel has no backward (ROADMAP A9b); "
                           "inputs that need a gradient would get none")
    if x.ndim != 3 or r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"rglru: x {tuple(x.shape)}, r_gate "
                         f"{tuple(r_gate.shape)} and i_gate "
                         f"{tuple(i_gate.shape)} must all be (B,S,W)")
    Bb, S, W = x.shape
    if log_lambda.shape != (W,) or (h0 is not None
                                    and h0.shape != (Bb, W)):
        raise ValueError(f"rglru: log_lambda must be ({W},) and h0 "
                         f"({Bb}, {W})")
    if S < 1:
        raise ValueError("rglru: the kernel takes S >= 1")
    if x.dtype not in _DTYPES or r_gate.dtype != x.dtype \
            or i_gate.dtype != x.dtype:
        raise ValueError(f"rglru: dtypes {x.dtype}/{r_gate.dtype}/"
                         f"{i_gate.dtype}; the kernel takes one of "
                         f"{_DTYPES} for all three")
    dev = x.device
    if any(t.device != dev for t in (r_gate, i_gate, log_lambda)) or (
            h0 is not None and h0.device != dev):
        raise ValueError("rglru: every input must be on one device")
    x, r_gate, i_gate = (t.contiguous() for t in (x, r_gate, i_gate))
    ll = log_lambda.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    L = CHUNK if chunk_len is None else int(chunk_len)
    if L < 1:
        raise ValueError(f"rglru: chunk_len {L} must be >= 1")
    nc = -(-S // L)
    out = torch.empty_like(x)
    hf = torch.empty((Bb, W), dtype=torch.float32, device=dev)
    # each chunk's (prod a, end state from 0)
    summ = (torch.empty((2, Bb, nc, W), dtype=torch.float32, device=dev)
            if nc > 1 else None)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
                 ll.data_ptr(), None if h0 is None else h0.data_ptr(),
                 out.data_ptr(), hf.data_ptr(),
                 None if summ is None else summ.data_ptr(), Bb, S, W, L,
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru.launches += 1
    return out, hf
