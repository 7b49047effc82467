"""Fletcher-64 checksum: the hand-written Hopper kernel and its plain
version.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/fletcher.py``
(``fletcher64_pallas``, body ``_kernel``): Fletcher-64 over uint32 words,
both running sums mod M = 2³²−1, result ``(s2 << 32) | s1``.  It is the
RPC layer's own integrity check: ``services.base.checksum_of`` runs it on
every checkpoint shard that lies on the card, where the shard is.  One
kernel, ``csrc/fletcher64.cu``.

**What bounds it on an H100.**  A few integer operations per 4-byte word:
bound by bytes at 3.35 TB/s (the 622 MB embedding of qwen1.5-0.5b needs
0.19 ms to read).

**What the design does about it.**  The kernel writes ``s2`` as
``n·s1 − Σ i·wᵢ``, two sums of independent terms that every thread
accumulates in 64-bit registers over 16-byte loads (four in flight), so
blocks need no order among themselves; a second one-block pass folds the
per-block partials.  The TPU kernel's end-around carries, which stood in
for 64-bit integers, are gone.

``fletcher64`` takes a tensor and checksums its raw bytes, zero-padded
to a 4-byte boundary (a uint32/int32 tensor: its words).  A CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
There is no fallback.  ``fletcher64.launches`` counts kernel launches
(each is the two passes).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

MOD = (1 << 32) - 1
# words per block of the plain version: with w < 2^32 and coefficients
# <= BLOCK, a block's weighted sum stays below 2^62 in int64
BLOCK = 1 << 15


def _raw_bytes(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes in memory order, as a flat uint8 tensor."""
    t = t.contiguous().reshape(-1)
    if t.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return t.view(torch.uint8)


def _words(x) -> torch.Tensor:
    """uint32 words of ``x``'s raw bytes (zero-padded to 4 bytes) as an
    int64 tensor on ``x``'s device (the CPU for a numpy array)."""
    if not isinstance(x, torch.Tensor):
        raw = np.ascontiguousarray(x).view(np.uint8).ravel()
        pad = (-raw.size) % 4
        if pad:
            raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
        return torch.from_numpy(raw.view(np.uint32).astype(np.int64))
    raw = _raw_bytes(x)
    pad = (-raw.numel()) % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(torch.int32).to(torch.int64) & MOD


def fletcher64_plain(x) -> int:
    """Fletcher-64 in exact int64 arithmetic, blockwise: a block of L
    words has partial sums s1_b = Σ w and s2_b = Σ (L−i)·w_i, and blocks
    compose as s1 = s1_a + s1_b, s2 = s2_a + s2_b + s1_a·L (mod M).
    Leading zero words change neither sum, so the words are padded at
    the front to whole blocks."""
    w = _words(x)
    n = w.numel()
    if n == 0:
        return 0
    nb = -(-n // BLOCK)
    w = torch.cat([w.new_zeros(nb * BLOCK - n), w]).view(nb, BLOCK)
    coef = torch.arange(BLOCK, 0, -1, dtype=torch.int64, device=w.device)
    b1 = w.sum(1) % MOD
    b2 = (w * coef).sum(1) % MOD
    before = (torch.cumsum(b1, 0) - b1) % MOD      # s1 of the blocks before
    s2 = int(((b2 + before * BLOCK % MOD) % MOD).sum()) % MOD
    s1 = int(b1.sum()) % MOD
    return (s2 << 32) | s1


def fletcher64(x) -> int:
    """Fletcher-64 of ``x``'s raw bytes as a Python int."""
    if not isinstance(x, torch.Tensor) or x.device.type == "cpu":
        return fletcher64_plain(x)
    return int(fletcher64_device(x).item()) & ((1 << 64) - 1)


fletcher64.launches = 0

_fns = None   # the C entries, bound once by _kernel()


def _kernel():
    """(blocks, checksum) C entries with their signatures set, built and
    loaded at the first launch."""
    global _fns
    if _fns is None:
        from .build import load
        lib = load("fletcher64")
        blocks = lib.repro_fletcher64_blocks
        blocks.restype = ctypes.c_int
        blocks.argtypes = [ctypes.c_uint64]
        fn = lib.repro_fletcher64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        _fns = (blocks, fn)
    return _fns


def fletcher64_device(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor: the checksum as a one-element
    int64 tensor (the u64 bits) on its device, not yet read back."""
    if x.device.type != "cuda":
        raise ValueError(f"fletcher64: no kernel for device {x.device}")
    raw = _raw_bytes(x)
    if raw.data_ptr() % 16:
        raw = raw.clone()           # a view at an odd offset: 16-byte loads
    nbytes = raw.numel()
    if nbytes // 4 >= MOD:
        raise ValueError(f"fletcher64: {nbytes} bytes is more words than "
                         f"the kernel indexes (< 2^32 - 1)")
    blocks, fn = _kernel()
    dev = raw.device
    partial = torch.empty(2 * blocks(nbytes), dtype=torch.int64, device=dev)
    out = torch.empty(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(raw.data_ptr(), nbytes, partial.data_ptr(), out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"fletcher64 kernel launch failed: CUDA error "
                           f"{err}")
    fletcher64.launches += 1
    return out
