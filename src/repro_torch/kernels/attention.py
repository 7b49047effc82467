"""Attention forward: the hand-written Hopper kernel and its plain version.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/flash_attention.py``
(``flash_attention``, body ``_kernel``), and takes over the two call sites
the reference leaves to XLA because that kernel rejects ``q_offset != 0``:
a prefill chunk at a scalar offset (``ops._attention_chunked``) and
decode with one position per batch row (``ops._attention_decode``).  One
kernel, ``csrc/flash_attention.cu``, serves prefill, chunk and decode.

**What bounds it on an H100.**  Serving runs it at small batch: decode
reads every live K/V row of the slot cache once per q head for one query
row, about one operation per byte, far below the ~295 operations per
byte at which the bf16 tensor cores, not the 3.35 TB/s of device memory,
become the limit.  Decode is bound by bytes.  Prefill at a few hundred
tokens does O(S) operations per byte of K/V and would be bound by
operations on the tensor cores.

**What the design does about it.**  Each block walks the key tiles of one
(query tile, head, batch row) itself and never loads a tile that every
row of the block has masked away (past the causal edge or ``q_offset[b]
+ S - 1``, before a sliding window, past ``T``), so decode reads only the
live prefix of each slot's cache.  Tiles are staged in shared memory once,
read 16 bytes at a time with several loads in flight per thread (decode
runs one 4-warp block per SM, so nothing else hides the memory latency),
and reused by all query rows of the block (16 for prefill and chunks).
Decode rows (``S <= 16``) get one row per block with the block's warps
splitting each key tile, instead of one live row in a 16-row tile.  The
products run on the CUDA cores in f32, not on the tensor cores: making
the prefill side fast (``wgmma``, TMA, split-K decode) is later work.

``attention`` dispatches on the device of ``q``: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises.  There is no
fallback.  ``attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)


def _positions(q_offset, B: int, S: int, device) -> torch.Tensor:
    """Absolute query positions, (1, S) for a scalar offset or (B, S)
    for a (B,) one."""
    off = torch.as_tensor(q_offset, device=device)
    rows = torch.arange(S, device=device)
    if off.ndim == 0:
        return (rows + off)[None, :]
    return off.reshape(B, 1) + rows[None, :]


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset=0,
                    prefix_len: Optional[int] = None) -> torch.Tensor:
    """Full-logit attention in f32, as ``ref.attention_ref`` (scalar
    ``q_offset``) and ``ops._attention_decode`` ((B,) ``q_offset``).

    q: (B,S,Hq,D); k, v: (B,T,Hkv,D) with Hq % Hkv == 0 → (B,S,Hq,D) in
    q's dtype."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qf = q.float()
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", qf, kf) * (1.0 / math.sqrt(D))
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = _positions(q_offset, B, S, q.device)[..., None]   # (B|1,S,1)
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones(qpos.shape[:2] + (T,), dtype=torch.bool,
                      device=q.device)
    if causal:
        cm = kpos <= qpos
        if prefix_len is not None:
            cm = cm | (kpos < prefix_len)
        mask = mask & cm
    if window > 0:
        mask = mask & (kpos > qpos - window)
    logits = torch.where(mask[:, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, vf).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              softcap: float = 0.0, q_offset=0,
              prefix_len: Optional[int] = None) -> torch.Tensor:
    """GQA attention forward; ``q_offset`` is an int, a 0-d tensor or a
    (B,) tensor of absolute positions of each row's first query."""
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset, prefix_len=prefix_len)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {q.device}")
    return _attention_cuda(q, k, v, **kw)


attention.launches = 0

_fwd = None   # the C entry, bound once by _kernel()


def _kernel():
    """The kernel's C entry with its signature set, built and loaded at
    the first launch.  Two threads racing here bind the same function."""
    global _fwd
    if _fwd is None:
        from .build import load
        fn = load("flash_attention").repro_flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        _fwd = fn
    return _fwd


def _attention_cuda(q, k, v, *, causal, window, softcap, q_offset,
                    prefix_len):
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
        raise ValueError(f"attention: head_dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}"
                         f"; the kernel takes one of {_DTYPES} for all")
    if k.device != q.device or v.device != q.device:
        raise ValueError("attention: q, k and v must be on one device")
    if isinstance(q_offset, torch.Tensor):
        off = q_offset.to(device=q.device, dtype=torch.int32)
        off = off.expand(B) if off.ndim == 0 else off.reshape(B)
    else:                                   # an int: no host-to-device copy
        off = torch.full((B,), int(q_offset), dtype=torch.int32,
                         device=q.device)
    off = off.contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("attention: k and v must be 16-byte aligned (the "
                         "kernel stages them with 16-byte loads)")
    out = torch.empty_like(q)

    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 off.data_ptr(), B, S, T, Hq, Hkv, D,
                 int(q.dtype == torch.bfloat16), int(bool(causal)),
                 int(window), float(softcap),
                 -1 if prefix_len is None else int(prefix_len),
                 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    attention.launches += 1
    return out
