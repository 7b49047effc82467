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
launched the kernels.  A fake tensor (the dry run's) takes the card's
branch up to the launch: it allocates what the launch would and adds the
call's work to the dry run's tally (``kernels/cost.py``).

**The backward** (training; the reference differentiates ``ops.ssd``
with XLA, there is no Pallas backward).  When an input needs a
gradient, ``ssd`` goes through :class:`SSDFunction`: the same forward,
which on the card keeps the states entering each chunk and the chunks'
decays, and :func:`ssd_bwd`: the kernels of ``csrc/ssd_bwd.cu`` on the
card (3xTF32 products on the tensor cores, no atomics; three launches: a
reverse walk a (row, head, half of N) that forms each chunk's dy ⊗ C sum
and the gradients of the states leaving the chunks, beside each chunk's
C·Bᵀ once a group; the chunk pass, whose dx blocks (a head, chunk, row)
write dx, ddt and the dA, dD partials and whose dB/dC blocks walk a
slice of a group's heads in order; the ordered sums over slices and over
(row, chunk)), :func:`ssd_bwd_plain` on the CPU.  The passes' plain
counterparts, held against it on the CPU: :func:`ssd_bwd_state_plain`,
:func:`ssd_chunk_cb_plain`, :func:`ssd_bwd_dx_plain`,
:func:`ssd_bwd_dbdc_plain`, :func:`ssd_bwd_reduce_plain`; the slice
size is :func:`ssd_bwd_plan`'s.  An h0 that needs a gradient takes it
from the walk's one more step, through chunk 0 (``with_dh0``).
``ssd_bwd.launches`` counts calls.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import cost
from .attention import SMS

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


def ssd_keep_plain(x, dt, A, B, C, D=None, h0=None):
    """What the forward kernels give ``SSDFunction`` (``_ssd_cuda`` with
    ``keep``), in plain torch: (y, h_final, the states entering each
    chunk (Bb,nc,H,P,N), the chunks' decays (Bb,nc,H)), the last two
    None for a sequence of one chunk."""
    y, hf = ssd_plain(x, dt, A, B, C, D, h0)
    if x.shape[1] <= CHUNK:
        return y, hf, None, None
    states, decay = ssd_chunk_states_plain(x, dt, A, B)
    entering, _ = ssd_state_passing_plain(states, decay, h0)
    return y, hf, entering.contiguous(), decay.contiguous()


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


def ssd_bwd_plain(x, dt, A, B, C, D, h0, dy, dh_final=None, *,
                  chunk: int = CHUNK, with_dh0: bool = False):
    """The gradients (dx, ddt, dA, dB, dC, dD) of the SSD's (y, h_final)
    from dy (and dh_final, None for zero), each in its input's dtype (dD
    None without D), in f32 as the kernels take them; ``with_dh0`` adds
    h0's, dh0 = decay_0·G_0 + R_0 (Bb,H,P,N), in h0's dtype (f32 without
    h0: the gradient of a zero initial state).  Per (row, head)
    and chunk of Q tokens, cum_i the in-chunk inclusive Σ dt·A,
    L_ij = exp(cum_i − cum_j) for j <= i, h_in the state entering the
    chunk and G the gradient of the state leaving it:

        G_{c−1} = exp(cum_Q) G_c + Σ_i exp(cum_i) dy_i ⊗ C_i,
        G_last = dh_final;
        dx_j = Σ_{i>=j} L_ij dt_j (C_i·B_j) dy_i
               + dt_j exp(cum_Q − cum_j) G B_j + D dy_j;
        dB_j = Σ_{i>=j} L_ij dt_j (dy_i·x_j) C_i
               + dt_j exp(cum_Q − cum_j) Gᵀ x_j;
        dC_i = Σ_{j<=i} L_ij dt_j (dy_i·x_j) B_j + exp(cum_i) h_inᵀ dy_i;

    and through the exponents: d(dt·A)_k sums every term whose exponent
    spans step k (the T_ij = L_ij dt_j (C_i·B_j)(dy_i·x_j) with
    i >= k > j, and the state terms), and gives ddt_k = A·d(dt·A)_k plus
    the direct terms and dA = Σ dt·d(dt·A).
    B's and C's gradients are summed over the heads of a group."""
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Q = chunk
    xf, dtf, dyf = _cut(x, Q), _cut(dt, Q), _cut(dy, Q)
    Bf, Cf = _cut(B, Q, rep), _cut(C, Q, rep)
    Af = A.float()
    cum = _cum(dt, A, Q)                                   # b,c,i,h f64
    nc = cum.shape[1]
    # the states entering each chunk and the chunks' decays, as the
    # forward's passes compute them
    states, decay = ssd_chunk_states_plain(x, dt, A, B, chunk=Q)
    entering, _ = ssd_state_passing_plain(states, decay, h0)
    ecum = torch.exp(cum.float())                          # exp(cum_i)
    to_end = torch.exp((cum[:, :, -1:] - cum).float())     # exp(cum_Q-cum_j)

    # the gradient of the state leaving each chunk, from the last back
    R = torch.einsum("bcih,bcihp,bcihn->bchpn", ecum, dyf, Cf)
    g = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
         if dh_final is None else dh_final.float())
    leaving = []
    for c in reversed(range(nc)):
        leaving.append(g)
        g = decay[:, c, :, None, None] * g + R[:, c]
    dS = torch.stack(leaving[::-1], dim=1)                 # b,c,h,p,n

    # in-chunk: L masked before exp (no overflow to mask after)
    above = torch.triu(torch.ones(Q, Q, dtype=torch.bool, device=x.device),
                       diagonal=1)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # b,c,i,j,h
    L = torch.exp(diff.float().masked_fill(above[None, None, :, :, None],
                                           float("-inf")))
    CB = torch.einsum("bcihn,bcjhn->bcijh", Cf, Bf)
    DX = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    dt_j = dtf[:, :, None, :, :]
    M1 = L * dt_j * CB
    M2 = L * dt_j * DX
    K = L * CB * DX
    dx = torch.einsum("bcijh,bcihp->bcjhp", M1, dyf)
    dBh = torch.einsum("bcijh,bcihn->bcjhn", M2, Cf)
    dCh = torch.einsum("bcijh,bcjhn->bcihn", M2, Bf)
    # the state terms
    GB = torch.einsum("bchpn,bcjhn->bcjhp", dS, Bf)
    w_end = (to_end * dtf)[..., None]
    dx = dx + w_end * GB
    dBh = dBh + w_end * torch.einsum("bchpn,bcjhp->bcjhn", dS, xf)
    HD = torch.einsum("bchpn,bcihp->bcihn", entering, dyf)
    dCh = dCh + ecum[..., None] * HD
    if D is not None:
        dx = dx + dyf * D.float()[None, None, None, :, None]

    # the exponents: T_ij = K_ij dt_j pulls cum_i up and cum_j down, so
    # d(dt A)_k takes the T_ij that straddle k (i >= k > j): the suffix
    # over i of each row's prefix over j < k, no cancelling sums
    Tm = K * dt_j
    Vd = to_end * (xf * GB).sum(-1)                        # b,c,j,h
    U = ecum * (Cf * HD).sum(-1)
    W = decay * (dS * entering).sum((-1, -2))              # b,c,h
    before = (torch.cumsum(Tm.double(), 3) - Tm.double())  # b,c,i,k,h
    straddle = torch.flip(torch.cumsum(torch.flip(before, [2]), 2), [2])
    da_T = torch.diagonal(straddle, dim1=2, dim2=3).permute(0, 1, 3, 2)
    rest = (U - dtf * Vd).double()
    rest[:, :, -1] += ((dtf * Vd).sum(2) + W).double()
    da = (da_T + torch.flip(torch.cumsum(torch.flip(rest, [2]), 2),
                            [2])).float()
    ddt = Af * da + K.sum(2) + Vd
    dA = (dtf * da).sum((0, 1, 2))
    dD = None if D is None else (dyf * xf).sum((0, 1, 2, 4))

    def back(t):            # (Bb,nc,Q,...) -> (Bb,S,...)
        return t.reshape(Bb, nc * Q, *t.shape[3:])[:, :S]
    dB = back(dBh).reshape(Bb, S, G, rep, N).sum(3)
    dC = back(dCh).reshape(Bb, S, G, rep, N).sum(3)
    grads = (back(dx).to(x.dtype), back(ddt).to(dt.dtype), dA.to(A.dtype),
             dB.to(B.dtype), dC.to(C.dtype),
             None if D is None else dD.to(D.dtype))
    if not with_dh0:
        return grads
    dh0 = decay[:, 0, :, None, None] * dS[:, 0] + R[:, 0]
    return grads + (dh0 if h0 is None else dh0.to(h0.dtype),)


def ssd_bwd_plan(B: int, S: int, H: int, G: int, N: int) -> int:
    """hs, the heads of a group that one dB/dC block of
    ``csrc/ssd_bwd.cu`` walks in order: the most, up to 16, that divide
    the group and still give one such block each of the card's ``SMS``,
    else 1.  Each such block is one (slice of hs heads, half of N, chunk,
    row); the slices' sums go through an (B, S, H / hs, N) f32 scratch.
    The dx blocks of the same launch fill the SMs around them.  The times
    at each hs are ``tools/scan_tuning.py --bwd``'s (PERF.md, PR 23)."""
    rep = H // G
    blocks = H * -(-N // 64) * -(-S // CHUNK) * B
    hs = 1
    for cand in range(2, min(16, rep) + 1):
        if rep % cand == 0 and blocks // cand >= SMS:
            hs = cand
    return hs


def ssd_chunk_cb_plain(B, C, *, chunk: int = CHUNK) -> torch.Tensor:
    """Each chunk's C·Bᵀ (Bb,nc,G,Q,Q) f32, once a group, as the
    backward's cb blocks form it: [i, j] = C_i·B_j, zero past the
    sequence; its readers take j <= i only."""
    return torch.einsum("bcign,bcjgn->bcgij", _cut(C, chunk), _cut(B, chunk))


def ssd_bwd_state_plain(dy, dt, A, C, decay, dh_final=None, *,
                        chunk: int = CHUNK, with_dh0: bool = False):
    """The gradient of the state leaving each chunk (Bb,nc,H,P,N) f32, as
    the backward's walk blocks form it: from the last chunk's (dh_final,
    or zero) back, G_{c−1} = decay_c·G_c + R_c, where
    R_c = Σ_i exp(cum_i)·dy_i ⊗ C_i is formed at the step that needs it.
    ``decay`` (Bb,nc,H) is the forward's (None for one chunk: exp(cum_Q),
    as the walk forms it).  The kernel writes all but the last into its
    scratch and reads dh_final for the last.  ``with_dh0`` returns
    (leaving, dh0) with dh0 = G_{−1} (Bb,H,P,N), the walk's one more
    step, through chunk 0."""
    Bb, S, H, P = dy.shape
    N = C.shape[3]
    rep = H // C.shape[2]
    dyf, Cf = _cut(dy, chunk), _cut(C, chunk, rep)
    cum = _cum(dt, A, chunk)
    nc = cum.shape[1]
    g = (torch.zeros((Bb, H, P, N), dtype=torch.float32, device=dy.device)
         if dh_final is None else dh_final.float())
    if decay is None:
        decay = torch.exp(cum[:, :, -1].float())
    leaving = [g] * nc
    for c in range(nc - 1, -1 if with_dh0 else 0, -1):
        R = torch.einsum("bihp,bihn->bhpn",
                         dyf[:, c] * torch.exp(cum[:, c].float())[..., None],
                         Cf[:, c])
        g = decay[:, c, :, None, None] * g + R
        if c > 0:
            leaving[c - 1] = g
    leaving = torch.stack(leaving, dim=1)
    return (leaving, g) if with_dh0 else leaving


def _bwd_chunk_terms(x, dt, A, dy, chunk):
    """What the chunk pass's blocks share: the f32 cut x, dt, dy, cum
    (f64), exp(cum_i), exp(cum_Q − cum_j) and the masked L_ij."""
    Q = chunk
    xf, dtf, dyf = _cut(x, Q), _cut(dt, Q), _cut(dy, Q)
    cum = _cum(dt, A, Q)
    above = torch.triu(torch.ones(Q, Q, dtype=torch.bool, device=x.device),
                       diagonal=1)
    L = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :]).float()
                  .masked_fill(above[None, None, :, :, None], float("-inf")))
    return (xf, dtf, dyf, cum, torch.exp(cum.float()),
            torch.exp((cum[:, :, -1:] - cum).float()), L)


def ssd_bwd_dx_plain(x, dt, A, B, C, D, dy, cb, leaving, entering, *,
                     chunk: int = CHUNK):
    """What the backward's dx blocks (one a head, chunk, row) write, from
    the chunks' C·Bᵀ (``ssd_chunk_cb_plain``), the gradients of the
    states leaving the chunks (``ssd_bwd_state_plain``) and the states
    entering them (Bb,nc,H,P,N): dx in x's dtype,
    M1ᵀ·dy + dt_j·exp(cum_Q − cum_j)·B·Gᵀ + D·dy with M1 = L·dt_j·CB;
    ddt (Bb,S,H) f32; and each block's dA and dD partials (Bb,nc,H) f32.
    r_i takes C·h_inᵀ (a (Q, P) product) dotted with dy_i; the
    straddling T_ij take each row's prefix over j < k in f64, then the
    sum over the rows i >= k."""
    Bb, S, H, P = x.shape
    rep = H // B.shape[2]
    xf, dtf, dyf, cum, ecum, to_end, L = _bwd_chunk_terms(x, dt, A, dy,
                                                          chunk)
    nc = cum.shape[1]
    Bf, Cf = _cut(B, chunk, rep), _cut(C, chunk, rep)
    CB = cb.float().repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2)
    DX = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    dt_j = dtf[:, :, None, :, :]
    M1 = L * dt_j * CB
    K = L * CB * DX
    GB = torch.einsum("bjhn,bhpn->bjhp", Bf.flatten(0, 1),
                      leaving.flatten(0, 1)).reshape(xf.shape)
    dx = torch.einsum("bcijh,bcihp->bcjhp", M1, dyf) \
        + (to_end * dtf)[..., None] * GB
    if D is not None:
        dx = dx + dyf * D.float()[None, None, None, :, None]
    Ch = torch.einsum("bihn,bhpn->bihp", Cf.flatten(0, 1),
                      entering.float().flatten(0, 1)).reshape(xf.shape)
    Vd = to_end * (xf * GB).sum(-1)                        # b,c,j,h
    U = ecum * (dyf * Ch).sum(-1)
    W = torch.exp(cum[:, :, -1].float()) * (leaving * entering).sum((-1, -2))
    Tm = (K * dt_j).double()
    before = torch.cumsum(Tm, 3) - Tm                      # b,c,i,k,h
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device))
    da_T = (before * tri[None, None, :, :, None]).sum(2)    # b,c,k,h
    rest = (U - dtf * Vd).double()
    rest[:, :, -1] += ((dtf * Vd).sum(2) + W).double()
    suffix = torch.flip(torch.cumsum(torch.flip(rest, [2]), 2), [2])
    da = (da_T + suffix).float()
    ddt = A.float() * da + K.sum(2) + Vd
    dA_part = (dtf * da).sum(2)
    dD_part = (dyf * xf).sum((2, 4))

    def back(t):
        return t.reshape(Bb, nc * chunk, *t.shape[3:])[:, :S]
    return back(dx).to(x.dtype), back(ddt), dA_part, dD_part


def ssd_bwd_dbdc_plain(x, dt, A, B, C, dy, leaving, entering, hs: int, *,
                       chunk: int = CHUNK):
    """The dB and dC partials (Bb,S,H/hs,N) f32 that the backward's dB/dC
    blocks write: for each slice of hs heads of a group, in head order,
    the sum of each head's M2ᵀ·C + (w∘x)·G and M2·B + (e∘dy)·h_in, with
    M2 = L·dt_j·(dy·xᵀ), w_j = dt_j·exp(cum_Q − cum_j), e_i =
    exp(cum_i)."""
    Bb, S, H, P = x.shape
    N = B.shape[3]
    rep = H // B.shape[2]
    xf, dtf, dyf, cum, ecum, to_end, L = _bwd_chunk_terms(x, dt, A, dy,
                                                          chunk)
    nc = cum.shape[1]
    Bf, Cf = _cut(B, chunk, rep), _cut(C, chunk, rep)
    M2 = L * dtf[:, :, None, :, :] * torch.einsum("bcihp,bcjhp->bcijh",
                                                  dyf, xf)
    dBh = torch.einsum("bcijh,bcihn->bcjhn", M2, Cf) + torch.einsum(
        "bcjhp,bchpn->bcjhn", xf * (to_end * dtf)[..., None], leaving)
    dCh = torch.einsum("bcijh,bcjhn->bcihn", M2, Bf) + torch.einsum(
        "bcihp,bchpn->bcihn", dyf * ecum[..., None], entering.float())

    def slices(t):          # heads summed in order within each slice
        t = t.reshape(Bb, nc * chunk, H // hs, hs, N)[:, :S]
        acc = t[:, :, :, 0]
        for k in range(1, hs):
            acc = acc + t[:, :, :, k]
        return acc
    return slices(dBh), slices(dCh)


def ssd_bwd_reduce_plain(dBp, dCp, dA_part, dD_part, G: int, dtype,
                         with_D: bool = True):
    """The last pass: dB and dC (Bb,S,G,N) in ``dtype``, each group's
    slices summed in slice order; dA and dD (H,) f32, the (row, chunk)
    partials summed (dD None without D)."""
    Bb, S, nsl, N = dBp.shape

    def groups(t):
        t = t.reshape(Bb, S, G, nsl // G, N)
        acc = t[:, :, :, 0]
        for k in range(1, nsl // G):
            acc = acc + t[:, :, :, k]
        return acc.to(dtype)
    dA = dA_part.sum((0, 1))
    dD = dD_part.sum((0, 1)) if with_D else None
    return groups(dBp), groups(dCp), dA, dD


def ssd_bwd(x, dt, A, B, C, D, h0, dy, dh_final=None, *, states=None,
            decay=None, chunk: int = CHUNK, with_dh0: bool = False):
    """(dx, ddt, dA, dB, dC, dD) and, ``with_dh0``, dh0:
    ``ssd_bwd_plain`` on the CPU (at ``chunk``), the backward kernels on
    the card, which read the forward's ``states`` (the state entering each
    chunk) and ``decay`` (each chunk's exp(cum_Q)) when the sequence has
    more than one chunk; no fallback."""
    if cost.route(x, "ssd_bwd") == "plain":
        return ssd_bwd_plain(x, dt, A, B, C, D, h0, dy, dh_final,
                             chunk=chunk, with_dh0=with_dh0)
    return _ssd_bwd_cuda(x, dt, A, B, C, D, h0, dy, dh_final, states, decay,
                         with_dh0=with_dh0)


ssd_bwd.launches = 0


class SSDFunction(torch.autograd.Function):
    """The SSD with its gradients: ``ssd``'s forward (the kernels keep
    the entering states and decays on the card), ``ssd_bwd`` backward,
    each dispatching on the device; an h0 that needs a gradient takes
    it."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk):
        if cost.route(x, "ssd") == "plain":
            y, hf = ssd_plain(x, dt, A, B, C, D, h0, chunk=chunk)
            states = decay = None
        else:
            y, hf, states, decay = _ssd_cuda(x, dt, A, B, C, D, h0,
                                             keep=True)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, D, h0, states, decay)
        ctx.set_materialize_grads(False)
        return y, hf

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, B, C, D, h0, states, decay = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        with_dh0 = ctx.needs_input_grad[6]
        grads = ssd_bwd(x, dt, A, B, C, D, h0, dy, dh_final, states=states,
                        decay=decay, chunk=ctx.chunk, with_dh0=with_dh0)
        return (*grads[:6], grads[6] if with_dh0 else None, None)


def ssd(x, dt, A, B, C, D=None, h0=None, *, chunk: int = 256
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_final) of the chunked SSD; see ``ssd_plain``.  On the card
    the kernels take their own chunk length, ``CHUNK``, whatever ``chunk``
    says: the SSD is chunk-invariant.  Inputs that need a gradient (h0
    among them) go through ``SSDFunction``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        return SSDFunction.apply(x, dt, A, B, C, D, h0, chunk)
    if cost.route(x, "ssd") == "plain":
        return ssd_plain(x, dt, A, B, C, D, h0, chunk=chunk)
    return _ssd_cuda(x, dt, A, B, C, D, h0)


ssd.launches = 0

_fn = None   # the C entries, bound once by _kernel() / _bwd_kernel()
_bwd_fn = None


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


def _bwd_kernel():
    """The backward's C entry (``csrc/ssd_bwd.cu``), bound at its first
    launch."""
    global _bwd_fn
    if _bwd_fn is None:
        from .build import load
        fn = load("ssd_bwd").repro_ssd_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        _bwd_fn = fn
    return _bwd_fn


def _bwd_occupancy():
    """``repro_ssd_bwd_occupancy``: each backward kernel's blocks, shared
    memory and blocks an SM at given shapes, bound at its first use."""
    from .build import load
    fn = load("ssd_bwd").repro_ssd_bwd_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return fn


def _check_inputs(name, x, dt, A, B, C, D, h0):
    """The kernels' shape, dtype and device rules, forward and backward."""
    if x.ndim != 4 or B.ndim != 4 or B.shape != C.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} must be (B,S,H,P) and "
                         f"B {tuple(B.shape)} / C {tuple(C.shape)} (B,S,G,N)")
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if B.shape[:2] != (Bb, S) or dt.shape != (Bb, S, H) \
            or A.shape != (H,) or G < 1 or H % G:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not fit (H % G == 0)")
    if S < 1 or P > MAX_P or N > MAX_N:
        raise ValueError(f"{name}: the kernel takes S >= 1, P <= {MAX_P}, "
                         f"N <= {MAX_N}; got S={S}, P={P}, N={N}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes x {x.dtype}, B {B.dtype}, C "
                         f"{C.dtype}; the kernel takes one of {_DTYPES} "
                         f"for all three")
    dev = x.device
    tensors = [x, dt, A, B, C] + [t for t in (D, h0) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every input must be on one device")
    if D is not None and D.shape != (H,):
        raise ValueError(f"{name}: D must be ({H},), got {tuple(D.shape)}")
    if h0 is not None and h0.shape != (Bb, H, P, N):
        raise ValueError(f"{name}: h0 must be {(Bb, H, P, N)}, got "
                         f"{tuple(h0.shape)}")


def _ssd_cuda(x, dt, A, B, C, D, h0, keep: bool = False):
    """One call on the card: one launch if the sequence is one chunk,
    else four.  ``keep`` also returns the scratch the backward reads: the
    states entering each chunk (B,nc,H,P,N) and the chunks' decays
    (B,nc,H), both None for one chunk."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, h0)):
        raise RuntimeError("ssd: this raw launch has no backward; inputs "
                           "that need a gradient go through ssd(), whose "
                           "SSDFunction carries it")
    _check_inputs("ssd", x, dt, A, B, C, D, h0)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dev = x.device
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
    if cost.is_fake(x):
        cost.add("ssd", *cost.ssd_work(Bb, S, H, P, G, N, x.element_size(),
                                       D is not None, h0 is not None))
        return (y, hf, states, decay) if keep else (y, hf)
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
    return (y, hf, states, decay) if keep else (y, hf)


def _ssd_bwd_cuda(x, dt, A, B, C, D, h0, dy, dh_final, states, decay, *,
                  hs=None, with_dh0: bool = False):
    """The backward on the card: three launches (``ssd_bwd_state``,
    ``ssd_bwd_chunk``, ``ssd_bwd_reduce``), one ``ssd_bwd.launches`` a
    call.  ``hs``, the heads a dB/dC block walks, is
    :func:`ssd_bwd_plan`'s unless given (it must divide H / G).
    ``with_dh0`` adds h0's gradient (B,H,P,N), in h0's dtype (f32 without
    h0), from one more step of the walk.  Scratch,
    f32: the gradients of the states leaving the chunks but the last
    (B,nc−1,H,P,N), each chunk's C·Bᵀ (B,nc,G,64,64), the slices' dB and
    dC (B,S,H/hs,N) and the blocks' dA, dD partials (B,nc,H)."""
    _check_inputs("ssd_bwd", x, dt, A, B, C, D, h0)
    Bb, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dev = x.device
    nc = -(-S // CHUNK)
    hs = ssd_bwd_plan(Bb, S, H, G, N) if hs is None else int(hs)
    if hs < 1 or (H // G) % hs:
        raise ValueError(f"ssd_bwd: hs {hs} must divide H / G = {H // G}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype} must "
                         f"be like x {tuple(x.shape)} {x.dtype}")
    if dh_final is not None and (dh_final.shape != (Bb, H, P, N)
                                 or dh_final.device != dev):
        raise ValueError(f"ssd_bwd: dh_final must be {(Bb, H, P, N)}")
    if nc > 1:
        if states is None or decay is None \
                or states.shape != (Bb, nc, H, P, N) \
                or decay.shape != (Bb, nc, H) \
                or states.dtype != torch.float32 \
                or decay.dtype != torch.float32:
            raise ValueError("ssd_bwd: needs the forward's entering states "
                             f"{(Bb, nc, H, P, N)} and decays {(Bb, nc, H)}, "
                             "f32")
        hin = states.contiguous()
        decay = decay.contiguous()
    else:               # one chunk: it enters with h0
        hin = None if h0 is None else h0.float().contiguous()
        decay = None
    xc, Bc, Cc, dyc = (t.contiguous() for t in (x, B, C, dy))
    dtf = dt.float().contiguous()
    Af = A.float().contiguous()
    Df = None if D is None else D.float().contiguous()
    dhf = None if dh_final is None else dh_final.float().contiguous()

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    dS = f32(Bb, nc - 1, H, P, N) if nc > 1 else None
    cb = f32(Bb, nc, G, CHUNK, CHUNK)
    dx = torch.empty_like(xc)
    ddt, dBp, dCp = f32(Bb, S, H), f32(Bb, S, H // hs, N), \
        f32(Bb, S, H // hs, N)
    dA_part, dD_part = f32(Bb, nc, H), f32(Bb, nc, H)
    dB, dC = torch.empty_like(Bc), torch.empty_like(Cc)
    dA, dD = f32(H), f32(H)
    dh0 = f32(Bb, H, P, N) if with_dh0 else None
    if cost.is_fake(x):
        cost.add("ssd_bwd", *cost.ssd_bwd_work(
            Bb, S, H, P, G, N, x.element_size(), D is not None,
            h0 is not None, dh_final is not None, nc))
    else:
        _launch_bwd(xc, dtf, Af, Bc, Cc, Df, dyc, hin, decay, dhf, dS, cb,
                    dx, ddt, dBp, dCp, dA_part, dD_part, dB, dC, dA, dD,
                    dh0, Bb, S, H, P, G, N, hs, h0 is not None)
    grads = (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC,
             None if D is None else dD.to(D.dtype))
    if not with_dh0:
        return grads
    return grads + (dh0 if h0 is None else dh0.to(h0.dtype),)


def _launch_bwd(xc, dtf, Af, Bc, Cc, Df, dyc, hin, decay, dhf, dS, cb, dx,
                ddt, dBp, dCp, dA_part, dD_part, dB, dC, dA, dD, dh0, Bb, S,
                H, P, G, N, hs, has_h0):
    """The backward's one C call (three kernels) on the card."""
    def ptr(t):
        return None if t is None else t.data_ptr()
    dev = xc.device
    fn = _bwd_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(xc), ptr(dtf), ptr(Af), ptr(Bc), ptr(Cc), ptr(Df),
                 ptr(dyc), ptr(hin), ptr(decay), ptr(dhf), ptr(dS), ptr(cb),
                 ptr(dx), ptr(ddt), ptr(dBp), ptr(dCp), ptr(dA_part),
                 ptr(dD_part), ptr(dB), ptr(dC), ptr(dA), ptr(dD), ptr(dh0),
                 Bb, S, H, P, G, N, hs, int(has_h0),
                 int(xc.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd backward launch failed: CUDA error {err}")
    ssd_bwd.launches += 1


def ssd_bwd_launch_plan(B: int, S: int, H: int, G: int, N: int,
                        dtype=torch.float32) -> dict:
    """The backward's launch plan at these shapes, on the card: launches
    a call, ``ssd_bwd_plan``'s hs, and each kernel's grid, dynamic shared
    memory bytes and blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), as the C side
    computes them for its launches."""
    hs = ssd_bwd_plan(B, S, H, G, N)
    out = (ctypes.c_int * 9)()
    err = _bwd_occupancy()(B, S, H, G, N, hs, int(dtype == torch.bfloat16),
                           out)
    if err != 0:
        raise RuntimeError(f"ssd backward occupancy query: CUDA error {err}")
    names = ("ssd_bwd_state", "ssd_bwd_chunk", "ssd_bwd_reduce")
    return {"launches": len(names), "hs": hs,
            "kernels": {name: {"blocks": out[3 * k],
                               "smem_bytes": out[3 * k + 1],
                               "blocks_per_sm": out[3 * k + 2]}
                        for k, name in enumerate(names)}}
