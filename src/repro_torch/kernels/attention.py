"""Attention forward: the hand-written Hopper kernels and their plain
versions.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``), and takes over the two call sites
the reference leaves to XLA because that kernel rejects ``q_offset != 0``:
a prefill chunk at a scalar offset (``ops._attention_chunked``) and
decode with one position per batch row (``ops._attention_decode``).  One
source, ``csrc/flash_attention.cu``, serves prefill, chunk and decode.

**Which dtype takes which route** (``plan``, from shapes and dtype alone):

- bf16, the dtype every serving path runs: ``attn_fwd_tc`` on the tensor
  cores (path ``"tc"``), split across blocks when the grid is short of
  the card, its partials merged by ``attn_combine`` in the same call.
- f32, the parity dtype: ``attn_fwd`` on the CUDA cores (path
  ``"simt"``), never split.  The tensor cores' f32 route is TF32, whose
  10 mantissa bits break the card's 1e-4 f32 tolerance.

**What bounds it on an H100.**  Prefill at a few hundred tokens and more
does O(S) operations per byte of K/V and is bound by the bf16 tensor
cores (989 TFLOP/s).  Decode and short chunks read every live K/V row
once for a few query rows: bound by bytes (3.35 TB/s), and at serving
batch by how few (kv head, batch row) blocks there are for 132 SMs.

**What the design does about it.**  The GQA group is packed into the
tile's rows (``packed_row``): a block owns one (kv head, batch row) and 64
rows of (query, q head), so every K/V tile it loads serves all the q
heads that read it (recurrentgemma's 16 MQA heads read a decode slot once,
not 16 times); a (kv head, batch row) with at most 16 such rows (decode)
takes 16-row blocks whose four warps split each key tile.  Both products
run as ``mma.sync`` bf16 tiles with f32 sums; K/V tiles stream through a
two-stage ``cp.async`` ring in swizzled bf16 shared memory; tiles that
every row has masked away are never loaded.  When the grid is short of
the card, ``plan`` gives ``n_split > 1``: each block takes one contiguous
range of the key tiles its rows can see (``key_splits``), writes
unnormalized O, m and l in f32 (``attention_partial_plain``), and
``attn_combine`` merges them (``combine_plain``).  ``plan`` reads no
tensor: decode's ``q_offset`` lives on the device and the model promises
no host sync.

``attention`` dispatches on the device of ``q``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  There is no
fallback.  A fake tensor (the dry run's, ``kernels/cost.py``) takes the
card's branch up to the launch: it allocates what the launch would,
adds the call's work to the dry run's tally and launches nothing.
``attention.launches`` counts one per call on the card, split or not
(the combine is part of the call).

**The gradient.**  The reference has no backward kernel (it trains
through XLA's autodiff of ``ops.attention``); here the forward is a
hand-written kernel, so its gradient is one too.  When an input needs a
gradient (training, ``q_offset`` 0), ``attention`` goes through
``AttentionFunction``: its forward also keeps the row log-sum-exp
(``attention_fwd``: the kernels write it beside O), its backward is
``attention_bwd`` — FlashAttention-2's backward, ``attention_bwd_plain``
on the CPU and ``csrc/flash_attention_bwd.cu`` on the card, by the route
``bwd_plan`` picks from shapes and dtype alone:

- bf16, every training path: the tensor cores (path ``"tc"``).
  ``attn_bwd_dq_tc`` first (it also writes Δ = rowsum(dO∘O) of its rows),
  then ``attn_bwd_dkdv_tc``, one block a 64-key tile of a (kv head, batch
  row) that sums its GQA group's packed rows.  Under MQA that grid is
  short of the card, so ``bwd_plan`` splits each block's rows into
  ``n_split`` ranges across blocks; the f32 partials
  (``attention_bwd_dkdv_partial_plain``) are summed in a fixed order by
  ``attn_bwd_dkdv_reduce`` (``dkdv_reduce_plain``).  No atomics: two
  calls give the same bits.
- f32, the parity dtype: the CUDA cores (path ``"simt"``): ``attn_bwd_pre``
  (Δ), ``attn_bwd_dkdv``, ``attn_bwd_dq``.

A bf16 call is two launches (three when split), an f32 call three;
``attention_bwd.launches`` counts one per call.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import cost

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
SMS = 132             # the H100's streaming multiprocessors
ROWS = 64             # packed (query, q head) rows of a tensor-core block
FRAG_ROWS = 16        # rows of one warp's MMA fragment: a block of at
#                       most this many rows splits its key tiles by warp
MIN_SPLIT_TILES = 2   # key tiles a split takes at the least
MAX_SPLITS = 16       # past this, more splits cost more than they save


def key_tile(D: int, rows: int) -> int:
    """Keys a tensor-core block stages a tile (``launch_tc`` in the
    source), at ``rows`` = S * Hq / Hkv packed rows a (kv head, batch
    row): 64, but 32 at head_dim 256 for 64-row blocks, whose O
    accumulator alone is 128 registers a thread.  At most 16 rows (one
    warp's fragment: decode, short prompts) take 16-row blocks whose four
    warps split each 64-key tile."""
    return 32 if D > 128 and rows > FRAG_ROWS else 64


def packed_row(r: int, hk: int, G: int):
    """The (query, q head) of packed row ``r`` of kv head ``hk``'s tiles
    at G = Hq / Hkv q heads a kv head, as the kernel maps them."""
    return r // G, hk * G + r % G


def plan(B: int, S: int, T: int, Hq: int, Hkv: int, D: int,
         dtype) -> tuple:
    """(path, n_split) of a call on the card, from shapes and dtype alone.

    f32 takes the CUDA cores (``"simt"``, one split).  bf16 takes the
    tensor cores (``"tc"``); when its (row tile, kv head, batch row)
    blocks fill under half of the card's SMs, the key tiles are split
    across blocks so that about one block runs on every SM, each split
    taking at least MIN_SPLIT_TILES of the ``ceil(T / key_tile)`` tiles,
    and never more than MAX_SPLITS splits: each split adds a block's
    fixed cost and a partial to merge (on an H100, recurrentgemma's decode
    of 4 slots of 3072 ran slower at 24, 33 and 48 splits than at 16).
    Whether the offset is a scalar or a (B,) tensor does not enter: the
    kernel splits the key range each block can see, read on the device."""
    if dtype != torch.bfloat16:
        return "simt", 1
    rows = S * (Hq // Hkv)
    blocks = -(-rows // (FRAG_ROWS if rows <= FRAG_ROWS else ROWS)) \
        * Hkv * B
    tiles = -(-T // key_tile(D, rows))
    if 2 * blocks > SMS:
        return "tc", 1
    return "tc", max(1, min(-(-SMS // blocks), tiles // MIN_SPLIT_TILES,
                            MAX_SPLITS))


def key_splits(k_begin: int, k_end: int, bk: int, n_split: int):
    """The kernel's split of keys ``[k_begin, k_end)`` into ``n_split``
    contiguous ranges of whole ``bk``-key tiles (some empty when there
    are fewer tiles than splits): a list of (lo, hi).  The backward's
    dK/dV kernel splits a key tile's packed rows the same way."""
    n = max(-(-(k_end - k_begin) // bk), 0)
    return [(min(k_begin + n * z // n_split * bk, k_end),
             min(k_begin + n * (z + 1) // n_split * bk, k_end))
            for z in range(n_split)]


DKDV_KEYS = 64        # keys of a tensor-core dK/dV block (kTcKeys)


def bwd_plan(B: int, S: int, T: int, Hq: int, Hkv: int, D: int,
             dtype) -> tuple:
    """(path, n_split) of a backward call on the card, from shapes and
    dtype alone.

    f32 takes the CUDA cores (``"simt"``, one split): the tensor cores'
    f32 is TF32, whose 10 mantissa bits break the f32 gradients' 1e-4.
    bf16 takes the tensor cores (``"tc"``).  Its dK/dV kernel runs one
    block a (64-key tile, kv head, batch row) and each walks the packed
    rows of its GQA group that see the tile; under MQA that grid is short
    of the card (recurrentgemma's 8 x 128: 16 blocks walking up to 32 row
    tiles each; paligemma's 8 x 384: 48 of up to 48).  So, as ``plan``
    splits the forward's keys, when those blocks fill under half of the
    SMs each block's row tiles are split into ``n_split`` contiguous
    ranges (``key_splits`` of the rows, in ``ROWS``-row tiles) across
    blocks, about one block an SM, each range at least MIN_SPLIT_TILES
    row tiles of the ``ceil(S * G / ROWS)``, at most MAX_SPLITS; the dQ
    kernel's (64 rows, kv head, batch row) blocks are never short."""
    if dtype != torch.bfloat16:
        return "simt", 1
    blocks = -(-T // DKDV_KEYS) * Hkv * B
    row_tiles = -(-S * (Hq // Hkv) // ROWS)
    if 2 * blocks > SMS:
        return "tc", 1
    return "tc", max(1, min(-(-SMS // blocks), row_tiles // MIN_SPLIT_TILES,
                            MAX_SPLITS))


def _positions(q_offset, B: int, S: int, device) -> torch.Tensor:
    """Absolute query positions, (1, S) for a scalar offset or (B, S)
    for a (B,) one.  An int offset copies nothing from the host (the
    plain versions run inside CUDA graphs when they are timed)."""
    rows = torch.arange(S, device=device)
    if not isinstance(q_offset, torch.Tensor):
        return (rows + int(q_offset))[None, :]
    off = q_offset.to(device)
    if off.ndim == 0:
        return (rows + off)[None, :]
    return off.reshape(B, 1) + rows[None, :]


def _logits(q, k, *, causal, window, softcap, q_offset, prefix_len,
            key_lo=0, key_hi=None):
    """f32 logits (B, Hq, S, T) and the (B|1, S, T) mask of the keys each
    query sees, restricted to keys ``[key_lo, key_hi)``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), kf) * (
        1.0 / math.sqrt(D))
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = _positions(q_offset, B, S, q.device)[..., None]   # (B|1,S,1)
    kpos = torch.arange(T, device=q.device)
    mask = (kpos >= key_lo) & (kpos < (T if key_hi is None else key_hi))
    mask = mask.expand(qpos.shape[:2] + (T,))
    if causal:
        cm = kpos <= qpos
        if prefix_len is not None:
            cm = cm | (kpos < prefix_len)
        mask = mask & cm
    if window > 0:
        mask = mask & (kpos > qpos - window)
    return logits, mask


def _values(v, Hq):
    return v.float().repeat_interleave(Hq // v.shape[2], dim=2)


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset=0,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    """Full-logit attention in f32, as ``ref.attention_ref`` (scalar
    ``q_offset``) and ``ops._attention_decode`` ((B,) ``q_offset``).

    q: (B,S,Hq,D); k, v: (B,T,Hkv,D) with Hq % Hkv == 0 → (B,S,Hq,D) in
    q's dtype."""
    logits, mask = _logits(q, k, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset,
                           prefix_len=prefix_len)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p,
                        _values(v, q.shape[2])).to(q.dtype)


def attention_partial_plain(q, k, v, key_lo: int, key_hi: int, *,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0, q_offset=0,
                            prefix_len: Optional[int] = None):
    """One split's partial state over keys ``[key_lo, key_hi)``, as the
    tensor-core kernel writes it: f32 row max m (B,S,Hq), row sum l and
    unnormalized O (B,S,Hq,D).  A row that sees no key of the range has
    m = NEG_INF, l = 0 and O = 0."""
    logits, mask = _logits(q, k, causal=causal, window=window,
                           softcap=softcap, q_offset=q_offset,
                           prefix_len=prefix_len, key_lo=key_lo,
                           key_hi=key_hi)
    mask = mask[:, None]                                  # (B|1,1,S,T)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(-1)                                   # (B,Hq,S)
    p = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    o = torch.einsum("bhst,bthd->bshd", p, _values(v, q.shape[2]))
    return m.transpose(1, 2), p.sum(-1).transpose(1, 2), o


def combine_plain(m, l, o, dtype):
    """``attn_combine``: merge partials stacked on a leading split axis
    (m, l (n,B,S,Hq); o (n,B,S,Hq,D)) into the output in ``dtype``:
    m* = max m_i, out = sum O_i e^(m_i - m*) / max(sum l_i e^(m_i - m*),
    1e-30)."""
    w = torch.exp(m - m.amax(0))
    lt = (l * w).sum(0)
    out = (o * w[..., None]).sum(0) / lt.clamp_min(1e-30)[..., None]
    return out.to(dtype)


def attention_fwd_plain(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        prefix_len: Optional[int] = None, q_offset=0):
    """(o, lse), as the kernels write them for training (``q_offset`` 0)
    and for a sequence-parallel decode's partial: o (B,S,Hq,D) in q's
    dtype, lse (B,Hq,S) f32 = m + log l over the scaled and soft-capped
    logits, -1e30 (NEG_INF) for a row that sees no key (whose o is 0)."""
    m, l, o = attention_partial_plain(q, k, v, 0, k.shape[1], causal=causal,
                                      window=window, softcap=softcap,
                                      q_offset=q_offset,
                                      prefix_len=prefix_len)
    o = o / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)), NEG_INF)
    return o.to(q.dtype), lse.transpose(1, 2)


def _bwd_scores(q, k, v, o, lse, do, *, causal, window, softcap,
                prefix_len):
    """(P, dZ) (B, Hq, S, T) f32 of the backward, and dO in f32."""
    Hq = q.shape[2]
    x, mask = _logits(q, k, causal=causal, window=window, softcap=softcap,
                      q_offset=0, prefix_len=prefix_len)
    live = mask[:, None] & (lse > NEG_INF / 10)[..., None]
    lse_safe = torch.where(lse > NEG_INF / 10, lse, 0.0)
    p = torch.where(live, torch.exp(x - lse_safe[..., None]), 0.0)
    dof = do.float()
    delta = (dof * o.float()).sum(-1).transpose(1, 2)     # (B,Hq,S)
    dp = torch.einsum("bshd,bthd->bhst", dof, _values(v, Hq))
    dz = p * (dp - delta[..., None])
    if softcap > 0.0:
        dz = dz * (1.0 - torch.square(x / softcap))
    return p, dz, dof


def _group_sum(g, Hkv):
    """(B, T, Hq, D) per q head -> (B, T, Hkv, D), summing each group."""
    B, T, Hq, D = g.shape
    return g.reshape(B, T, Hkv, Hq // Hkv, D).sum(3)


def attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        prefix_len: Optional[int] = None):
    """(dq, dk, dv) in the inputs' dtypes: FlashAttention-2's backward
    algebra written out in f32 (not autograd), from the forward's o and
    lse, as ``attn_bwd_*`` compute it::

        P = exp(x - lse)  (0 where masked or lse is NEG_INF)
        dV = P^T dO    dP = dO V^T    Delta = rowsum(dO * o)
        dZ = P (dP - Delta) (1 - tanh^2)    dQ = scale dZ K
        dK = scale dZ^T Q

    x is the scaled, soft-capped logit; the (1 - tanh^2) factor is the
    softcap's (absent without one).  A kv head's gradient sums its GQA
    group's q heads."""
    Hq, D = q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    p, dz, dof = _bwd_scores(q, k, v, o, lse, do, causal=causal,
                             window=window, softcap=softcap,
                             prefix_len=prefix_len)
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2)
    dq = torch.einsum("bhst,bthd->bshd", dz, kf) * scale
    dk = torch.einsum("bhst,bshd->bthd", dz, q.float()) * scale
    return (dq.to(q.dtype), _group_sum(dk, Hkv).to(k.dtype),
            _group_sum(dv, Hkv).to(v.dtype))


def attention_bwd_dkdv_partial_plain(q, k, v, o, lse, do, row_lo: int,
                                     row_hi: int, *, causal: bool = True,
                                     window: int = 0, softcap: float = 0.0,
                                     prefix_len: Optional[int] = None):
    """One split's partial (dk, dv), f32 (B, T, Hkv, D), over the packed
    rows ``[row_lo, row_hi)`` of every kv head's group (row r: query r // G
    of the group's q head r % G, ``packed_row``), as ``attn_bwd_dkdv_tc``
    writes it when split: dk already scaled.  ``dkdv_reduce_plain`` of
    the partials of ranges that cover [0, S * G) is
    ``attention_bwd_plain``'s dk and dv."""
    S, Hq, D = q.shape[1], q.shape[2], q.shape[3]
    Hkv = k.shape[2]
    G = Hq // Hkv
    p, dz, dof = _bwd_scores(q, k, v, o, lse, do, causal=causal,
                             window=window, softcap=softcap,
                             prefix_len=prefix_len)
    r = (torch.arange(S, device=q.device)[None, :] * G
         + torch.arange(Hq, device=q.device)[:, None] % G)   # (Hq, S)
    rows = ((r >= row_lo) & (r < row_hi))[None, :, :, None]
    p = torch.where(rows, p, 0.0)
    dz = torch.where(rows, dz, 0.0)
    dv = torch.einsum("bhst,bshd->bthd", p, dof)
    dk = torch.einsum("bhst,bshd->bthd", dz, q.float()) * (1.0 / math.sqrt(D))
    return _group_sum(dk, Hkv), _group_sum(dv, Hkv)


def dkdv_reduce_plain(dk_part, dv_part, dtype):
    """``attn_bwd_dkdv_reduce``: the partials stacked on a leading split
    axis, summed in the order z = 0 .. n - 1, in ``dtype``."""
    dk, dv = dk_part[0], dv_part[0]
    for z in range(1, len(dk_part)):
        dk, dv = dk + dk_part[z], dv + dv_part[z]
    return dk.to(dtype), dv.to(dtype)


def attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, prefix_len: Optional[int] = None,
                  q_offset=0):
    """(o, lse): the plain version on the CPU, the forward kernel (which
    then also writes lse) on the card.  ``q_offset`` 0 for the backward;
    a sequence-parallel decode's partial passes the query's position
    relative to its block of keys."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len, q_offset=q_offset)
    if cost.route(q, "attention") == "plain":
        return attention_fwd_plain(q, k, v, **kw)
    return _attention_cuda(q, k, v, with_lse=True, **kw)


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                  window: int = 0, softcap: float = 0.0,
                  prefix_len: Optional[int] = None):
    """(dq, dk, dv): ``attention_bwd_plain`` on the CPU, the backward
    kernels on the card; no fallback."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              prefix_len=prefix_len)
    if cost.route(q, "attention") == "plain":
        return attention_bwd_plain(q, k, v, o, lse, do, **kw)
    return _attention_bwd_cuda(q, k, v, o, lse, do, **kw)


attention_bwd.launches = 0


class AttentionFunction(torch.autograd.Function):
    """Attention at ``q_offset`` 0 with its gradient: ``attention_fwd``
    forward (o and the row lse kept), ``attention_bwd`` backward, each
    dispatching on the device as ``attention`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, prefix_len):
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      prefix_len=prefix_len)
        o, lse = attention_fwd(q, k, v, **ctx.kw)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do.contiguous(),
                                   **ctx.kw)
        return dq, dk, dv, None, None, None, None


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_offset=0,
              prefix_len: Optional[int] = None) -> torch.Tensor:
    """GQA attention forward; ``q_offset`` is an int, a 0-d tensor or a
    (B,) tensor of absolute positions of each row's first query.  On the
    card bf16 runs on the tensor cores and f32 on the CUDA cores
    (``plan``).  When q, k or v needs a gradient the call goes through
    ``AttentionFunction``, which takes ``q_offset`` 0 only (training)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if isinstance(q_offset, torch.Tensor) or q_offset != 0:
            raise RuntimeError("attention: the backward takes q_offset 0 "
                               "(full-sequence training); inputs that need "
                               "a gradient came with an offset")
        return AttentionFunction.apply(q, k, v, causal, window, softcap,
                                       prefix_len)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, prefix_len=prefix_len)
    if cost.route(q, "attention") == "plain":
        return attention_plain(q, k, v, **kw)
    return _attention_cuda(q, k, v, **kw)


attention.launches = 0

_fwd = None   # the C entries, bound once by _kernel() / _bwd_kernel()
_bwd = None


def _kernel():
    """The kernel's C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fwd
    if _fwd is None:
        from .build import load
        fn = load("flash_attention").repro_flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        _fwd = fn
    return _fwd


def _bwd_kernel():
    """The backward's C entry (``csrc/flash_attention_bwd.cu``), bound at
    its first launch."""
    global _bwd
    if _bwd is None:
        from .build import load
        fn = load("flash_attention_bwd").repro_flash_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        _bwd = fn
    return _bwd


def _kernel_dim(D: int, dims, name: str) -> int:
    """The head dim the kernels run ``D`` at, a multiple of 16 they have
    no tile for: the next of ``dims`` above it (nemotron's 192 runs at
    256, the backward's 16 and 32 at 64).  Any other head dim outside
    ``dims`` is refused."""
    for d in dims:
        if d >= D and D % 16 == 0:
            return d
    raise ValueError(f"{name}: head_dim {D} not in {dims}")


def _pad_dim(t, D: int):
    """``t`` with its last dim zero-padded to ``D``."""
    return torch.nn.functional.pad(t, (0, D - t.shape[-1]))


def _attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset=0,
                    prefix_len: Optional[int] = None,
                    n_split: Optional[int] = None, with_lse: bool = False,
                    scale: Optional[float] = None):
    """One launch on the card (two with the combine).  ``n_split`` forces
    the number of key splits of a bf16 call (tests and the smoke run
    only); None takes ``plan``'s.  ``with_lse`` returns (out, lse), lse
    (B,Hq,S) f32 written by the same launches.  A head dim the kernels
    have no tile for runs at the next one they have, q, k and v
    zero-padded (the padding adds nothing to q·k, and o's padded dims
    are dropped) at the scale of the true head dim."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("attention: this raw launch has no backward; "
                           "inputs that need a gradient go through "
                           "attention(), whose AttentionFunction carries "
                           "it")
    B, S, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"attention: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        Dk = _kernel_dim(D, HEAD_DIMS, "attention")
        got = _attention_cuda(
            _pad_dim(q, Dk), _pad_dim(k, Dk), _pad_dim(v, Dk), causal=causal,
            window=window, softcap=softcap, q_offset=q_offset,
            prefix_len=prefix_len, n_split=n_split, with_lse=with_lse,
            scale=1.0 / math.sqrt(D))
        return (got[0][..., :D], got[1]) if with_lse else got[..., :D]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                         f"; the kernel takes one of {_DTYPES} for all")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k and v must be on one device")
    path, planned = plan(B, S, T, Hq, Hkv, D, q.dtype)
    n_split = planned if n_split is None else int(n_split)
    if n_split < 1 or (path == "simt" and n_split != 1):
        raise ValueError(f"attention: n_split {n_split} on the {path} path "
                         f"(f32 runs unsplit)")
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.to(device=q.device, dtype=torch.int32)
        off = off.expand(B) if off.ndim == 0 else off.reshape(B)
    else:                                   # an int: no host-to-device copy
        off = torch.full((B,), int(q_offset), dtype=torch.int32,
                         device=q.device)
    off = off.contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    fake = cost.is_fake(q)
    if not fake and (q.data_ptr() % 16 or k.data_ptr() % 16
                     or v.data_ptr() % 16):
        raise ValueError("attention: q, k and v must be 16-byte aligned "
                         "(the kernels stage them 16 bytes at a time)")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    o_part = ml_part = None
    if n_split > 1:        # the splits' f32 partials, merged on the card
        o_part = torch.empty((n_split, B, S, Hq, D), dtype=torch.float32,
                             device=q.device)
        ml_part = torch.empty((n_split, B, S, Hq, 2), dtype=torch.float32,
                              device=q.device)
    if fake:
        # a position a fake tensor holds is unread: the cache's end
        offsets = ([T - S] * B if isinstance(q_offset, torch.Tensor)
                   else [int(q_offset)] * B)
        cost.add("flash_attention", *cost.attention_work(
            B, S, T, Hq, Hkv, D, q.element_size(), offsets, causal, window,
            prefix_len))
        return (out, lse) if with_lse else out

    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 off.data_ptr(),
                 None if o_part is None else o_part.data_ptr(),
                 None if ml_part is None else ml_part.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, S, T, Hq, Hkv, D, int(path == "tc"), int(bool(causal)),
                 int(window), float(softcap),
                 -1 if prefix_len is None else int(prefix_len),
                 1.0 / math.sqrt(D) if scale is None else scale, n_split,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    attention.launches += 1
    return (out, lse) if with_lse else out


BWD_HEAD_DIMS = (64, 128, 256)


def _attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        prefix_len: Optional[int] = None,
                        n_split: Optional[int] = None,
                        scale: Optional[float] = None):
    """The backward on the card, one ``attention_bwd.launches`` a call:
    bf16 ``attn_bwd_dq_tc``, ``attn_bwd_dkdv_tc`` (and
    ``attn_bwd_dkdv_reduce`` when split), f32 ``attn_bwd_pre``,
    ``attn_bwd_dkdv``, ``attn_bwd_dq``.  ``n_split`` forces the row splits
    of a bf16 call (tests and the smoke run only); None takes
    ``bwd_plan``'s.  A head dim the kernels have no tile for runs at
    the next one, as the forward's."""
    B, S, Hq, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)} disagree")
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"attention_bwd: Hq={Hq} is not a multiple of "
                         f"Hkv={Hkv}")
    if D not in BWD_HEAD_DIMS:
        Dk = _kernel_dim(D, BWD_HEAD_DIMS, "attention_bwd")
        grads = _attention_bwd_cuda(
            *(_pad_dim(t, Dk) for t in (q, k, v, o)), lse, _pad_dim(do, Dk),
            causal=causal, window=window, softcap=softcap,
            prefix_len=prefix_len, n_split=n_split,
            scale=1.0 / math.sqrt(D))
        return tuple(g[..., :D] for g in grads)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, do)):
        raise ValueError(f"attention_bwd: q, k, v, o and do must share one "
                         f"of {_DTYPES}")
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"attention_bwd: lse must be (B, Hq, S) f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if any(t.device != q.device for t in (k, v, o, lse, do)):
        raise ValueError("attention_bwd: all inputs must be on one device")
    path, planned = bwd_plan(B, S, T, Hq, Hkv, D, q.dtype)
    n_split = planned if n_split is None else int(n_split)
    if n_split < 1 or (path == "simt" and n_split != 1):
        raise ValueError(f"attention_bwd: n_split {n_split} on the {path} "
                         f"path (f32 runs unsplit)")
    q, k, v, o, lse, do = (t.contiguous() for t in (q, k, v, o, lse, do))
    fake = cost.is_fake(q)
    if path == "tc" and not fake and any(t.data_ptr() % 16
                                         for t in (q, k, v, o, do)):
        raise ValueError("attention_bwd: q, k, v, o and do must be 16-byte "
                         "aligned (the kernels stage them 16 bytes at a "
                         "time)")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    part = None
    if n_split > 1:        # the splits' f32 dK (scaled) and dV, summed
        part = torch.empty((n_split, 2, B, T, Hkv, D), dtype=torch.float32,
                           device=q.device)
    if fake:
        cost.add("flash_attention_bwd", *cost.attention_bwd_work(
            B, S, T, Hq, Hkv, D, q.element_size(), causal, window,
            prefix_len))
        return dq, dk, dv
    fn = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if part is None else part.data_ptr(),
                 B, S, T, Hq, Hkv, D, int(path == "tc"),
                 int(bool(causal)), int(window), float(softcap),
                 -1 if prefix_len is None else int(prefix_len),
                 1.0 / math.sqrt(D) if scale is None else scale, n_split,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    attention_bwd.launches += 1
    return dq, dk, dv
