"""Mamba2 SSD (state-space duality): the hand-written Hopper kernels,
their plain versions and the one-token decode step.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/ssd.py``
(``ssd_pallas``, body ``_kernel``), which ``ops.ssd`` resolves to on a
TPU: every SSD layer's prefill runs it.  Kernels in ``csrc/ssd.cu``.
Decode does not launch them: the reference computes a decode step
outside any Pallas kernel (``ops.ssd_decode_step``), and so does
:func:`ssd_decode_step` here.

**What bounds it on an H100.**  The function needs 2·P·N + P
multiply-adds a token and head (the recurrent form) on P + 2·N/rep
values read.  The kernels' products run on the tensor cores in 3xTF32
(each f32 operand split into two TF32 parts, three products: about f32
accuracy, where plain TF32 misses the port's 2e-4), at whose 495 TFLOP/s
peak the bound at mamba2's P 64, N 128 is the bytes.

**What the design does about it.**  The chunk axis, sequential on the
TPU, is parallel here: a call is four launches, each block one (head or
group, chunk of 64 tokens, row), so that prefill's batch of 1 fills the
card: ``ssd_chunk_cb`` forms each chunk's C·Bᵀ once for the heads of a
group, which share it; ``ssd_chunk_state`` sums each chunk's own state
from zero,
``ssd_state_passing`` walks the chunks in order per state element and
turns them into the states entering each chunk (and h_final), and
``ssd_chunk_scan`` computes y from a chunk's tokens (the causal half of
C·Bᵀ only) and its entering state.  A sequence of one chunk (the demo's
short prompts) is one launch of the scan from h0, which also writes
h_final.  Their plain counterparts, held against :func:`ssd_plain` on the CPU:
:func:`ssd_chunk_states_plain`, :func:`ssd_state_passing_plain`,
:func:`ssd_chunk_scan_plain`.

**Rounding of the reassociation.**  Each chunk's state is summed from
zero and then passed, h_c = decay_c·h_{c−1} + S_c, where the
sequential form adds every token into the running state; the in-chunk
cumulative decay is summed and differenced in f64.

``ssd`` dispatches on the device of ``x``: a CPU tensor takes the plain
version, a CUDA tensor launches the kernels or raises.  There is no
fallback.  ``ssd.launches`` counts calls (one per layer's prefill) that
launched the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

MAX_P = 64       # head dim the kernel's state tile covers
MAX_N = 128      # state dim the kernel's shared memory holds
CHUNK = 64       # the kernels' chunk length
_DTYPES = (torch.float32, torch.bfloat16)


def ssd_plain(x, dt, A, B, C, D=None, h0=None, *, chunk: int = 256
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in f32, the algebra of ``ops._ssd_chunked``:
    quadratic within ``chunk``-long chunks, the state carried across
    them; the decay exponents are summed over each segment rather than
    taken as differences of cumulative sums.

    x (Bb,S,H,P), dt (Bb,S,H) (already softplus'ed), A (H,) negative,
    B and C (Bb,S,G,N) with H % G == 0, D (H,) and h0 (Bb,H,P,N)
    optional → (y (Bb,S,H,P) in x's dtype, h_final (Bb,H,P,N) f32).
    The sequence is padded with dt = 0, an identity step."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = min(chunk, S)
    pad = (-S) % Q
    Sp = S + pad
    nc = Sp // Q
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, H, P)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(Bb, nc, Q, H)
    Bf = F.pad(B.float().repeat_interleave(rep, dim=2),
               (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, H, N)
    Cf = F.pad(C.float().repeat_interleave(rep, dim=2),
               (0, 0, 0, 0, 0, pad)).reshape(Bb, nc, Q, H, N)

    da = dtf * A.float()                            # log-decay steps
    cum = torch.cumsum(da, dim=2)                   # inclusive, in-chunk
    # seg[i, j] = cum_i - cum_j = sum of da over j < k <= i, summed over
    # the segment itself: the difference of two long cumulative sums
    # loses ~|cum|·2^-24 of the exponent (at mamba2's A down to -16 and a
    # 256-token chunk, ~2e-4).  Masked (i < j) before exp.
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    steps = da[:, :, :, None, :].expand(Bb, nc, Q, Q, H)        # b,c,k,j,h
    seg = torch.cumsum(steps.masked_fill(~below[None, None, :, :, None],
                                         0.0), dim=2)           # b,c,i,j,h
    seg = seg.masked_fill(~tri[None, None, :, :, None], -1e30)
    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i·B_j) x_j
    cb = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    scores = cb * torch.exp(seg) * dtf[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    # each chunk's own end state (weights exp(cum_last - cum_j), the last
    # row of seg), then the carry across chunks
    w = torch.exp(seg[:, :, -1]) * dtf
    chunk_state = torch.einsum("bcjhn,bcjhp->bchpn", w[..., None] * Bf, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prev = torch.stack(entering, dim=1)                         # b,c,h,p,n
    y = y + torch.einsum("bcihn,bchpn->bcihp",
                         torch.exp(cum)[..., None] * Cf, h_prev)

    y = y.reshape(Bb, Sp, H, P)[:, :S]
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def _cut(t, Q: int, rep: int = 1):
    """(Bb,S,K,*tail) as f32 (Bb,nc,Q,K·rep,*tail), zero past S (dt = 0
    is an identity step); rep repeats each group for its heads."""
    t = t.float().repeat_interleave(rep, dim=2)
    pad = (-t.shape[1]) % Q
    t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, Q, *t.shape[2:])


def _cum(dt, A, Q: int):
    """cum (Bb,nc,Q,H): the inclusive in-chunk sum of dt·A, the products
    in f32 and the sum in f64, as the kernels take it."""
    return torch.cumsum((_cut(dt, Q) * A.float()).double(), dim=2)


def ssd_chunk_states_plain(x, dt, A, B, *, chunk: int = CHUNK
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's own end state from a zero state and its decay, as
    ``ssd_chunk_state`` computes them: states (Bb,nc,H,P,N) =
    Σ_j exp(cum_last − cum_j)·dt_j·x_j ⊗ B_j, decay (Bb,nc,H) =
    exp(cum_last), in f32."""
    rep = x.shape[2] // B.shape[2]
    xf, dtf, Bf = _cut(x, chunk), _cut(dt, chunk), _cut(B, chunk, rep)
    cum = _cum(dt, A, chunk)
    last = cum[:, :, -1:]
    w = torch.exp((last - cum).float()) * dtf
    states = torch.einsum("bcjhp,bcjhn->bchpn", xf * w[..., None], Bf)
    return states, torch.exp(last[:, :, 0].float())


def ssd_state_passing_plain(states, decay, h0=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state entering each chunk, h_c = decay_c·h_{c−1} + S_c from h0
    (or zero), as ``ssd_state_passing`` computes them in place: →
    (entering (Bb,nc,H,P,N), h_final (Bb,H,P,N)), f32."""
    Bb, nc, H, P, N = states.shape
    h = (torch.zeros((Bb, H, P, N), dtype=torch.float32,
                     device=states.device) if h0 is None else h0.float())
    entering = []
    for c in range(nc):
        entering.append(h)
        h = decay[:, c, :, None, None] * h + states[:, c]
    return torch.stack(entering, dim=1), h


def ssd_chunk_scan_plain(x, dt, A, B, C, entering, D=None, *,
                         chunk: int = CHUNK) -> torch.Tensor:
    """y of every chunk from its own tokens and the state entering it, as
    ``ssd_chunk_scan`` computes it: Σ_{j≤i} exp(cum_i − cum_j)·dt_j·
    (C_i·B_j)·x_j + exp(cum_i)·C_i·h_enterᵀ + D·x_i, in x's dtype."""
    Bb, S, H, P = x.shape
    rep = H // B.shape[2]
    xf, dtf = _cut(x, chunk), _cut(dt, chunk)
    Bf, Cf = _cut(B, chunk, rep), _cut(C, chunk, rep)
    cum = _cum(dt, A, chunk)
    Q = chunk
    above = torch.triu(torch.ones(Q, Q, dtype=torch.bool, device=x.device),
                       diagonal=1)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # b,c,i,j,h
    decay = torch.exp(diff.float().masked_fill(
        above[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf) * decay \
        * dtf[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)
    y = y + torch.exp(cum.float())[..., None] * torch.einsum(
        "bcihn,bchpn->bcihp", Cf, entering.float())
    y = y.reshape(Bb, -1, H, P)[:, :S]
    if D is not None:
        y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t, D=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token, as ``ops.ssd_decode_step``: h (B,H,P,N), x_t (B,H,P),
    dt_t (B,H), B_t and C_t (B,G,N) → (y_t (B,H,P) in x_t's dtype,
    h_new (B,H,P,N) f32)."""
    rep = x_t.shape[1] // B_t.shape[1]
    xf = x_t.float()
    dtf = dt_t.float()
    Bf = B_t.float().repeat_interleave(rep, dim=1)
    Cf = C_t.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(A.float()[None] * dtf)
    h_new = h.float() * decay[..., None, None] + \
        torch.einsum("bhp,bhn->bhpn", xf * dtf[..., None], Bf)
    y = torch.einsum("bhpn,bhn->bhp", h_new, Cf)
    if D is not None:
        y = y + xf * D.float()[None, :, None]
    return y.to(x_t.dtype), h_new


def ssd(x, dt, A, B, C, D=None, h0=None, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_final) of the chunked SSD; see ``ssd_plain``.  On the card
    the kernels take their own chunk length, ``CHUNK``, whatever ``chunk``
    says: the SSD is chunk-invariant."""
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, D, h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    return _ssd_cuda(x, dt, A, B, C, D, h0)


ssd.launches = 0

_fn = None   # the C entry, bound once by _kernel()


def _kernel():
    """The kernels' C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("ssd").repro_ssd_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _ssd_cuda(x, dt, A, B, C, D, h0):
    """One call on the card: one launch if the sequence is one chunk,
    else four."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        raise RuntimeError("ssd: the kernel has no backward (ROADMAP A9b); "
                           "inputs that need a gradient would get none")
    if x.ndim != 4 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(f"ssd: x {tuple(x.shape)} must be (B,S,H,P) and "
                         f"B {tuple(B.shape)} / C {tuple(C.shape)} (B,S,G,N)")
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if B.shape[:2] != (Bb, S) or dt.shape != (Bb, S, H) \
            or A.shape != (H,) or G < 1 or H % G:
        raise ValueError(f"ssd: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not fit (H % G == 0)")
    if S < 1 or P > MAX_P or N > MAX_N:
        raise ValueError(f"ssd: the kernel takes S >= 1, P <= {MAX_P}, "
                         f"N <= {MAX_N}; got S={S}, P={P}, N={N}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd: dtypes x {x.dtype}, B {B.dtype}, C "
                         f"{C.dtype}; the kernel takes one of {_DTYPES} "
                         f"for all three")
    dev = x.device
    tensors = [x, dt, A, B, C] + [t for t in (D, h0) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError("ssd: every input must be on one device")
    if D is not None and D.shape != (H,):
        raise ValueError(f"ssd: D must be ({H},), got {tuple(D.shape)}")
    if h0 is not None and h0.shape != (Bb, H, P, N):
        raise ValueError(f"ssd: h0 must be {(Bb, H, P, N)}, got "
                         f"{tuple(h0.shape)}")
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    D = None if D is None else D.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    nc = -(-S // CHUNK)
    y = torch.empty_like(x)
    hf = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    states = decay = cb = None
    if nc > 1:          # the chunk states, then the entering states
        states = torch.empty((Bb, nc, H, P, N), dtype=torch.float32,
                             device=dev)
        decay = torch.empty((Bb, nc, H), dtype=torch.float32, device=dev)
        # each chunk's C·Bᵀ, shared by the heads of a group
        cb = torch.empty((Bb, nc, G, CHUNK, CHUNK), dtype=torch.float32,
                         device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), None if D is None else D.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 hf.data_ptr(), None if states is None else states.data_ptr(),
                 None if decay is None else decay.data_ptr(),
                 None if cb is None else cb.data_ptr(), Bb, S, H, P, G, N,
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
    ssd.launches += 1
    return y, hf
