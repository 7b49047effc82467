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
fallback.  ``rglru.launches`` counts calls (one per layer's prefill or
training forward) that launched the kernels.  A fake tensor (the dry
run's) takes the card's branch up to the launch: it allocates what the
launch would and adds the call's work to the dry run's tally
(``kernels/cost.py``).

**The backward** (training; ``csrc/rglru_bwd.cu``).  The reference has no
Pallas backward: XLA differentiates ``ops.rglru``.  With gₜ the gradient
of hₜ, run in reverse (g at S from dh and dh_final, gₜ = dhₜ + aₜ₊₁·gₜ₊₁)::

    dx = g·σi·β,   di = g·x·β·σi(1 − σi)
    dlog a = g·hₜ₋₁·a − g·σi·x·a²/β    (second term 0 where the clamp binds)
    dr = dlog a·(−8·softplus(Λ))·σr(1 − σr),   dΛ = Σ dlog a·(−8·σr)·σ(Λ)
    dh0 = a₀·g₀

The same chunk split runs backwards, in one launch whose blocks are (row,
chunk, 64 or 128 channels): each stages its chunk's x, gates and dh in
shared memory at once, rebuilds hₜ₋₁ from the state the forward kept at
the chunk's entry (``_rglru_cuda(keep=True)``), publishes its chunk's pair
(A_c, the chunk's Π aₜ, and e_c = a·g at its first step from g = 0),
folds the later chunks' pairs into the g leaving its chunk from dh_final
(blocks take chunks by an atomic ticket, last first, so that a block
waits only on blocks that have started), runs the chunk in reverse and
writes dx, dr, di and one dΛ partial a (row, chunk, channel); chunk 0
writes dh0; the last block of each channel block sums its partials in a
fixed order.  No atomic sums: repeats are bitwise.  f32 and bf16 inputs,
f32 arithmetic.  Plain counterparts of the kernel's phases:
:func:`rglru_keep_plain`, :func:`rglru_bwd_chunk_summary_plain` (the
pairs), :func:`rglru_bwd_chunk_apply_plain` (the fold and the reverse
runs), :func:`rglru_bwd_reduce_plain`; the sequential backward they are
held against is :func:`rglru_bwd_plain`.  :class:`RGLRUFunction` carries
it; ``rglru_bwd.launches`` counts backward calls on the card.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cost

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


def _work_dtype(x):
    """The backward's arithmetic: f64 for f64 inputs (an oracle run),
    else f32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _bwd_terms(x, r_gate, i_gate, log_lambda, wd):
    """σr, σi, x, a, β and the clamp's mask (1 − a² > 1e-12) in ``wd``."""
    sr = torch.sigmoid(r_gate.to(wd))
    si = torch.sigmoid(i_gate.to(wd))
    log_a = -RGLRU_C * F.softplus(log_lambda.to(wd)) * sr
    om = 1.0 - torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp_min(om, 1e-12))
    return sr, si, x.to(wd), torch.exp(log_a), beta, om > 1e-12


def _bwd_step(g, hp, sr, si, xf, a, beta, free, coef):
    """One step's (dx, dr, di, dlog a·σr) from its g and hₜ₋₁."""
    dla = g * hp * a - torch.where(free, g * si * xf * a * a / beta,
                                   torch.zeros_like(g))
    return (g * si * beta, dla * coef * sr * (1.0 - sr),
            g * xf * beta * si * (1.0 - si), dla * sr)


def rglru_bwd_plain(x, r_gate, i_gate, log_lambda, h0, dh, dh_final=None
                    ) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`rglru_plain`, sequential: from the gradients
    of h (B,S,W; None: zero) and h_final (B,W; None: zero), (dx, dr_gate,
    di_gate, dlog_lambda, dh0) in the inputs' dtypes (dh0 in h0's, or the
    arithmetic's when h0 is None: the gradient of a zero initial state).
    Arithmetic in f32 (f64 for f64 inputs)."""
    Bb, S, W = x.shape
    wd = _work_dtype(x)
    sr, si, xf, a, beta, free = _bwd_terms(x, r_gate, i_gate, log_lambda,
                                           wd)
    coef = -RGLRU_C * F.softplus(log_lambda.to(wd))
    h = (torch.zeros((Bb, W), dtype=wd, device=x.device) if h0 is None
         else h0.to(wd))
    prev = []
    for t in range(S):
        prev.append(h)
        h = a[:, t] * h + si[:, t] * xf[:, t] * beta[:, t]
    carry = (torch.zeros((Bb, W), dtype=wd, device=x.device)
             if dh_final is None else dh_final.to(wd))
    gs = [None] * S
    for t in reversed(range(S)):
        gs[t] = carry if dh is None else dh[:, t].to(wd) + carry
        carry = a[:, t] * gs[t]
    dx, dr, di, part = _bwd_step(torch.stack(gs, 1), torch.stack(prev, 1),
                                 sr, si, xf, a, beta, free, coef)
    dll = -RGLRU_C * torch.sigmoid(log_lambda.to(wd)) * part.sum((0, 1))
    return (dx.to(x.dtype), dr.to(r_gate.dtype), di.to(i_gate.dtype),
            dll.to(log_lambda.dtype), carry.to(wd if h0 is None else h0.dtype))


def rglru_keep_plain(x, r_gate, i_gate, log_lambda, h0=None, *,
                     chunk: int = CHUNK):
    """(h, h_final, states): :func:`rglru_plain`'s outputs and what the
    forward kernels keep for the backward, the f32 state entering each
    chunk (B,nc,W) from h0 (or zero); None for one chunk."""
    h, hf = rglru_plain(x, r_gate, i_gate, log_lambda, h0)
    Bb, S, W = x.shape
    nc = -(-S // chunk)
    if nc == 1:
        return h, hf, None
    h32 = h if x.dtype == torch.float32 else rglru_plain(
        x.float(), r_gate, i_gate, log_lambda, h0)[0]
    first = (torch.zeros((Bb, 1, W), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float()[:, None])
    return h, hf, torch.cat(
        [first, h32[:, chunk - 1:(nc - 1) * chunk:chunk]], 1)


def _chunked_bwd_terms(x, r_gate, i_gate, log_lambda, dh, L: int):
    """``_bwd_terms`` and dh (Bb,nc,L,W) in f32, past S padded with
    identity steps: σr = σi = x = dh = 0 and a = 1 there, so the step adds
    nothing and takes no gradient."""
    terms = _bwd_terms(x, r_gate, i_gate, log_lambda, torch.float32)
    d = torch.zeros_like(terms[2]) if dh is None else dh.float()
    pad = (-x.shape[1]) % L
    Bb, W = x.shape[0], x.shape[2]

    def chunked(t, value=0.0):
        return F.pad(t, (0, 0, 0, pad), value=value).reshape(Bb, -1, L, W)
    sr, si, xf, a, beta, free = terms
    return (chunked(sr), chunked(si), chunked(xf), chunked(a, 1.0),
            chunked(beta, 1.0), chunked(free.float()) > 0, chunked(d))


def rglru_bwd_chunk_summary_plain(x, r_gate, i_gate, log_lambda, dh, *,
                                  chunk: int = CHUNK
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's backward pair, the one the backward kernel's blocks
    publish: (A (Bb,nc,W) = Π aₜ over the chunk, e (Bb,nc,W) = a·g at the
    chunk's first step, g run in reverse from 0 at its end), f32.  The
    kernel sums e forward, e = Σₜ (a₀…aₜ)·dhₜ: the same value, rounded
    in another order."""
    _, _, _, a, _, _, d = _chunked_bwd_terms(x, r_gate, i_gate, log_lambda,
                                             dh, chunk)
    carry = torch.zeros_like(a[:, :, 0])
    prod = torch.ones_like(carry)
    for t in reversed(range(chunk)):
        carry = a[:, :, t] * (d[:, :, t] + carry)
        prod = prod * a[:, :, t]
    return prod, carry


def rglru_bwd_chunk_apply_plain(x, r_gate, i_gate, log_lambda, h0, dh,
                                dh_final, A, e, states, *,
                                chunk: int = CHUNK
                                ) -> Tuple[torch.Tensor, ...]:
    """The rest of the backward kernel's block, after its pair: the g
    leaving each chunk folded from dh_final (or zero) over the later
    chunks' pairs (C = A_c·C + e_c), hₜ₋₁ recomputed from the forward's
    kept entering ``states`` (h0 or zero for one chunk), the chunk run in
    reverse → (dx, dr_gate, di_gate (Bb,S,W) f32, the dΛ partials
    Σₜ dlog aₜ·σrₜ (Bb,nc,W), dh0 (Bb,W) f32: the carry leaving chunk
    0's first step).  The kernel forms a partial before its reverse run,
    from sums taken forward with the carry C still unknown (gₜ is the run
    from 0 plus C times the product of the a after t), and dh0 as
    e_0 + A_0·C: the same values, rounded in another order."""
    Bb, S, W = x.shape
    sr, si, xf, a, beta, free, d = _chunked_bwd_terms(
        x, r_gate, i_gate, log_lambda, dh, chunk)
    nc = a.shape[1]
    coef = -RGLRU_C * F.softplus(log_lambda.float())
    C = (torch.zeros((Bb, W), dtype=torch.float32, device=x.device)
         if dh_final is None else dh_final.float())
    leaving = [None] * nc
    for c in reversed(range(nc)):
        leaving[c] = C
        C = A[:, c] * C + e[:, c]
    if states is None:
        states = (torch.zeros((Bb, 1, W), dtype=torch.float32,
                              device=x.device) if h0 is None
                  else h0.float()[:, None])
    h, prev = states.float(), []
    for t in range(chunk):
        prev.append(h)
        h = a[:, :, t] * h + si[:, :, t] * xf[:, :, t] * beta[:, :, t]
    carry, outs = torch.stack(leaving, 1), [None] * chunk
    for t in reversed(range(chunk)):
        g = d[:, :, t] + carry
        outs[t] = _bwd_step(g, prev[t], sr[:, :, t], si[:, :, t],
                            xf[:, :, t], a[:, :, t], beta[:, :, t],
                            free[:, :, t], coef)
        carry = a[:, :, t] * g

    def back(i):
        return torch.stack([o[i] for o in outs], 2).reshape(Bb, -1, W)[:, :S]
    partials = torch.stack([o[3] for o in outs], 2).sum(2)
    return back(0), back(1), back(2), partials, carry[:, 0]


def rglru_bwd_reduce_plain(partials, log_lambda) -> torch.Tensor:
    """dΛ (W,) from the (Bb,nc,W) partials, as the backward kernel's last
    block of each channel block sums them: −8·σ(Λ)·Σ over rows, then
    chunks, in that order."""
    s = torch.zeros_like(partials[0, 0])
    for b in range(partials.shape[0]):
        for c in range(partials.shape[1]):
            s = s + partials[b, c]
    return -RGLRU_C * torch.sigmoid(log_lambda.float()) * s


def rglru_bwd(x, r_gate, i_gate, log_lambda, h0, dh, dh_final=None, *,
              states=None) -> Tuple[torch.Tensor, ...]:
    """(dx, dr_gate, di_gate, dlog_lambda, dh0): :func:`rglru_bwd_plain`
    on the CPU, the backward kernel on the card, which reads the forward's
    ``states`` (the state entering each chunk) when the sequence has more
    than one chunk; no fallback."""
    if cost.route(x, "rglru_bwd") == "plain":
        return rglru_bwd_plain(x, r_gate, i_gate, log_lambda, h0, dh,
                               dh_final)
    return _rglru_bwd_cuda(x, r_gate, i_gate, log_lambda, h0, dh, dh_final,
                           states)


rglru_bwd.launches = 0


class RGLRUFunction(torch.autograd.Function):
    """The RG-LRU with its gradients: ``rglru``'s forward (on the card the
    kernels keep each chunk's entering state), ``rglru_bwd`` backward,
    each dispatching on the device; h0, when given, takes its gradient
    too."""

    @staticmethod
    def forward(ctx, x, r_gate, i_gate, log_lambda, h0):
        if cost.route(x, "rglru") == "plain":
            h, hf = rglru_plain(x, r_gate, i_gate, log_lambda, h0)
            states = None
        else:
            h, hf, states = _rglru_cuda(x, r_gate, i_gate, log_lambda, h0,
                                        keep=True)
        ctx.save_for_backward(x, r_gate, i_gate, log_lambda, h0, states)
        ctx.set_materialize_grads(False)
        return h, hf

    @staticmethod
    def backward(ctx, dh, dh_final):
        x, r_gate, i_gate, log_lambda, h0, states = ctx.saved_tensors
        *grads, dh0 = rglru_bwd(x, r_gate, i_gate, log_lambda, h0, dh,
                                dh_final, states=states)
        return (*grads, dh0 if ctx.needs_input_grad[4] else None)


def rglru(x, r_gate, i_gate, log_lambda, h0=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, h_final) of the RG-LRU; see ``rglru_plain``.  Inputs that need
    a gradient (h0 among them) go through ``RGLRUFunction``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, r_gate, i_gate, log_lambda, h0)):
        return RGLRUFunction.apply(x, r_gate, i_gate, log_lambda, h0)
    if cost.route(x, "rglru") == "plain":
        return rglru_plain(x, r_gate, i_gate, log_lambda, h0)
    return _rglru_cuda(x, r_gate, i_gate, log_lambda, h0)


rglru.launches = 0

_fn = None   # the C entries, bound once by _kernel() / _bwd_kernel()
_bwd_fn = None
_sync_ints = None
# the backward kernel's int32 tickets, counts and flags, one buffer a
# device, zero between launches (each launch leaves them zero)
_sync = {}


def _kernel():
    """The kernels' C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("rglru_scan").repro_rglru_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _fn = fn
    return _fn


def _bwd_kernel():
    """The backward's C entries (``csrc/rglru_bwd.cu``): the launch and the
    size of its sync buffer, bound at the first launch."""
    global _bwd_fn, _sync_ints
    if _bwd_fn is None:
        from .build import load
        lib = load("rglru_bwd")
        words = lib.rglru_bwd_sync_ints
        words.restype = ctypes.c_longlong
        words.argtypes = [ctypes.c_int] * 4
        fn = lib.repro_rglru_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        _sync_ints, _bwd_fn = words, fn
    return _bwd_fn


def _sync_words(dev, n: int) -> torch.Tensor:
    """The backward kernel's sync buffer on ``dev``, at least ``n`` int32
    words: allocated zero at the first call that needs it (so warm a
    shape up before capturing it in a CUDA graph) and left zero by every
    launch.  Launches that share it run in stream order: the port runs
    its backward on one stream."""
    buf = _sync.get(dev)
    if buf is None or buf.numel() < n:
        buf = _sync[dev] = torch.zeros(max(n, 1 << 12), dtype=torch.int32,
                                       device=dev)
    return buf


def _check_inputs(name, x, r_gate, i_gate, log_lambda, h0, dtypes):
    """The kernels' shape, dtype and device rules, forward and backward."""
    if x.ndim != 3 or r_gate.shape != x.shape or i_gate.shape != x.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)}, r_gate "
                         f"{tuple(r_gate.shape)} and i_gate "
                         f"{tuple(i_gate.shape)} must all be (B,S,W)")
    Bb, S, W = x.shape
    if log_lambda.shape != (W,) or (h0 is not None
                                    and h0.shape != (Bb, W)):
        raise ValueError(f"{name}: log_lambda must be ({W},) and h0 "
                         f"({Bb}, {W})")
    if S < 1:
        raise ValueError(f"{name}: the kernel takes S >= 1")
    if x.dtype not in dtypes or r_gate.dtype != x.dtype \
            or i_gate.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes {x.dtype}/{r_gate.dtype}/"
                         f"{i_gate.dtype}; the kernel takes one of "
                         f"{dtypes} for all three")
    dev = x.device
    if any(t.device != dev for t in (r_gate, i_gate, log_lambda)) or (
            h0 is not None and h0.device != dev):
        raise ValueError(f"{name}: every input must be on one device")


def _rglru_cuda(x, r_gate, i_gate, log_lambda, h0, chunk_len=None,
                keep: bool = False):
    """One call on the card: one launch if the sequence is one chunk,
    else two.  ``chunk_len`` forces L (tests and the smoke run only);
    None takes ``CHUNK``.  ``keep`` also returns what the backward reads:
    the f32 state entering each chunk (B,nc,W), None for one chunk."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, r_gate, i_gate, log_lambda, h0)):
        raise RuntimeError("rglru: this raw launch has no backward; inputs "
                           "that need a gradient go through rglru(), whose "
                           "RGLRUFunction carries it")
    _check_inputs("rglru", x, r_gate, i_gate, log_lambda, h0, _DTYPES)
    Bb, S, W = x.shape
    dev = x.device
    x, r_gate, i_gate = (t.contiguous() for t in (x, r_gate, i_gate))
    ll = log_lambda.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    L = CHUNK if chunk_len is None else int(chunk_len)
    if L < 1:
        raise ValueError(f"rglru: chunk_len {L} must be >= 1")
    if keep and L != CHUNK:
        raise ValueError(f"rglru: the backward reads states at chunk "
                         f"{CHUNK}, not {L}")
    nc = -(-S // L)
    out = torch.empty_like(x)
    hf = torch.empty((Bb, W), dtype=torch.float32, device=dev)
    # each chunk's (prod a, end state from 0)
    summ = (torch.empty((2, Bb, nc, W), dtype=torch.float32, device=dev)
            if nc > 1 else None)
    states = (torch.empty((Bb, nc, W), dtype=torch.float32, device=dev)
              if keep and nc > 1 else None)
    if cost.is_fake(x):
        cost.add("rglru_scan", *cost.rglru_work(
            Bb, S, W, x.element_size(), h0 is not None,
            nc if keep else 1))
        return (out, hf, states) if keep else (out, hf)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
                 ll.data_ptr(), None if h0 is None else h0.data_ptr(),
                 out.data_ptr(), hf.data_ptr(),
                 None if summ is None else summ.data_ptr(),
                 None if states is None else states.data_ptr(), Bb, S, W, L,
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru.launches += 1
    return (out, hf, states) if keep else (out, hf)


def _rglru_bwd_cuda(x, r_gate, i_gate, log_lambda, h0, dh, dh_final,
                    states):
    """The backward on the card: one launch, one ``rglru_bwd.launches`` a
    call; x, the gates and dh f32 or bf16 (one dtype), sums and states
    f32.  → (dx, dr_gate, di_gate in x's dtype, dlog_lambda, dh0 (B,W) in
    h0's dtype, f32 without h0).  Scratch: each chunk's pair (2,B,nc,W),
    the dΛ partials (B,nc,W) and the device's sync buffer."""
    _check_inputs("rglru_bwd", x, r_gate, i_gate, log_lambda, h0, _DTYPES)
    Bb, S, W = x.shape
    nc = -(-S // CHUNK)
    if dh is not None and (dh.shape != x.shape or dh.dtype != x.dtype):
        raise ValueError(f"rglru_bwd: dh {tuple(dh.shape)} {dh.dtype} must "
                         f"be like x {tuple(x.shape)} {x.dtype}")
    if dh_final is not None and dh_final.shape != (Bb, W):
        raise ValueError(f"rglru_bwd: dh_final must be ({Bb}, {W})")
    if nc > 1 and (states is None or states.shape != (Bb, nc, W)
                   or states.dtype != torch.float32):
        raise ValueError(f"rglru_bwd: {nc} chunks need the forward's "
                         f"entering states, f32 ({Bb}, {nc}, {W})")
    dev = x.device
    if any(t is not None and t.device != dev
           for t in (dh, dh_final, states)):
        raise ValueError("rglru_bwd: every input must be on one device")
    x, r_gate, i_gate = (t.contiguous() for t in (x, r_gate, i_gate))
    dh = None if dh is None else dh.contiguous()
    ll = log_lambda.float().contiguous()
    h0f, dh_final, states = (None if t is None else t.float().contiguous()
                             for t in (h0, dh_final, states))
    dx, dr, di = (torch.empty_like(x) for _ in range(3))
    dll = torch.empty((W,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((Bb, W), dtype=torch.float32, device=dev)
    pairs = (torch.empty((2, Bb, nc, W), dtype=torch.float32, device=dev)
             if nc > 1 else None)
    partials = torch.empty((Bb, nc, W), dtype=torch.float32, device=dev)
    if cost.is_fake(x):
        cost.add("rglru_bwd", *cost.rglru_bwd_work(
            Bb, S, W, x.element_size(), h0 is not None,
            dh_final is not None, nc))
        return (dx, dr, di, dll.to(log_lambda.dtype),
                dh0 if h0 is None else dh0.to(h0.dtype))
    fn = _bwd_kernel()
    is_bf16 = int(x.dtype == torch.bfloat16)
    sync = _sync_words(dev, _sync_ints(Bb, S, W, is_bf16))

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), r_gate.data_ptr(), i_gate.data_ptr(),
                 ll.data_ptr(), ptr(h0f), ptr(dh), ptr(dh_final),
                 ptr(states), dx.data_ptr(), dr.data_ptr(), di.data_ptr(),
                 dll.data_ptr(), dh0.data_ptr(), ptr(pairs),
                 partials.data_ptr(), sync.data_ptr(), Bb, S, W, is_bf16,
                 stream)
    if err != 0:
        raise RuntimeError(f"rglru_bwd kernel launch failed: CUDA error "
                           f"{err}")
    rglru_bwd.launches += 1
    return (dx, dr, di, dll.to(log_lambda.dtype),
            dh0 if h0 is None else dh0.to(h0.dtype))
