"""Fletcher-64 checksums: the hand-written Hopper kernel and its plain
version.

**Replaces** the Pallas TPU kernel ``src/repro/kernels/fletcher.py``
(``fletcher64_pallas``, body ``_kernel``): Fletcher-64 over uint32 words,
both running sums mod M = 2³²−1, result ``(s2 << 32) | s1``.  It is the
RPC layer's own integrity check: ``services.base`` runs it on every
checkpoint shard that lies on the card, where the shard is, all of a
checkpoint's shards in one batch.  One kernel, ``csrc/fletcher64.cu``.

**What bounds it on an H100.**  A few integer operations per 4-byte word:
bound by bytes at 3.35 TB/s (qwen1.5-0.5b's 1.86 GB of shards need
0.55 ms to read).  Most shards are small (4 KB norms), and for them a
launch, not bytes, is the floor.

**What the design does about it.**  The kernel writes ``s2`` as
``n·s1 − Σ i·wᵢ``, two sums of independent terms that every thread
accumulates in 64-bit registers over 16-byte loads (four in flight), so
blocks need no order among themselves.  One launch pair takes a whole
batch of buffers: pass-1 blocks are dealt to the buffers in proportion to
their bytes (at least one each, at most ``MAX_BLOCKS`` in all unless
there are more buffers), each block finds its buffer in a prefix table,
and pass 2 folds each buffer's partials with a warp.  The TPU kernel's
end-around carries, which stood in for 64-bit integers, are gone.

``fletcher64_many`` takes a list of tensors (or numpy arrays) and
checksums each one's raw bytes, zero-padded to a 4-byte boundary (a
uint32/int32 tensor: its words), reading the results back once.  CUDA
tensors launch the kernel, one batch per card; CPU tensors and numpy
arrays take the plain version.  There is no fallback.
``fletcher64(x)`` is a batch of one.  ``fletcher64.launches`` counts
kernel launches, one per batch (each is the two passes).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import numpy as np
import torch

MOD = (1 << 32) - 1
# words per block of the plain version: with w < 2^32 and coefficients
# <= BLOCK, a block's weighted sum stays below 2^62 in int64
BLOCK = 1 << 15
# the kernel's pass-1 block: 256 threads x 16 bytes x 4 loads in flight
BYTES_PER_BLOCK = 256 * 16 * 4
MAX_BLOCKS = 132 * 8     # 8 blocks per SM of an H100


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


def fletcher64_many_plain(xs: Sequence) -> List[int]:
    """``fletcher64_plain`` of each buffer."""
    return [fletcher64_plain(x) for x in xs]


def fletcher64_many(xs: Sequence) -> List[int]:
    """Fletcher-64 of each buffer's raw bytes, as Python ints: the CUDA
    tensors in one launch pair per card and one read-back, the rest by
    the plain version."""
    out: List[int] = [0] * len(xs)
    on_card = {}
    for i, x in enumerate(xs):
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            on_card.setdefault(x.device, []).append(i)
        else:
            out[i] = fletcher64_plain(x)
    for where in on_card.values():
        got = fletcher64_many_device([xs[i] for i in where]).tolist()
        for i, v in zip(where, got):
            out[i] = v & ((1 << 64) - 1)
    return out


def fletcher64(x) -> int:
    """Fletcher-64 of ``x``'s raw bytes as a Python int."""
    return fletcher64_many([x])[0]


fletcher64.launches = 0

_fn = None   # the C entry, bound once by _kernel()


def _kernel():
    """The C entry with its signature set, built and loaded at the first
    launch."""
    global _fn
    if _fn is None:
        from .build import load
        fn = load("fletcher64").repro_fletcher64_many
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _fn = fn
    return _fn


def blocks_for(sizes: Sequence[int]) -> List[int]:
    """Pass-1 blocks per buffer: enough for each buffer's bytes, at least
    one each; over ``MAX_BLOCKS`` in all, the blocks beyond one a buffer
    are dealt in proportion to bytes."""
    need = [max(1, -(-n // BYTES_PER_BLOCK)) for n in sizes]
    if sum(need) <= MAX_BLOCKS:
        return need
    spare = max(MAX_BLOCKS - len(sizes), 0)
    total = max(sum(sizes), 1)
    return [min(nd, 1 + spare * n // total) for nd, n in zip(need, sizes)]


class Batch:
    """A batch prepared for the kernel: the buffers' raw bytes (a copy
    where a view is not 16-byte aligned), the device table and the
    scratch.  ``launch`` enqueues the two passes; it copies nothing from
    the host, so a CUDA graph can hold it."""

    def __init__(self, xs: Sequence[torch.Tensor]):
        if not xs:
            raise ValueError("fletcher64: an empty batch")
        dev = xs[0].device
        raws = []
        for x in xs:
            if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
                where = x.device if isinstance(x, torch.Tensor) else "numpy"
                raise ValueError(f"fletcher64: no kernel for device "
                                 f"{where}")
            if x.device != dev:
                raise ValueError(f"fletcher64: a batch lies on one card, "
                                 f"got {dev} and {x.device}")
            raw = _raw_bytes(x)
            if raw.data_ptr() % 16:
                raw = raw.clone()   # a view at an odd offset: 16-byte loads
            if raw.numel() // 4 >= MOD:
                raise ValueError(f"fletcher64: {raw.numel()} bytes is more "
                                 f"words than the kernel indexes "
                                 f"(< 2^32 - 1)")
            raws.append(raw)
        sizes = [r.numel() for r in raws]
        prefix = np.concatenate([[0], np.cumsum(blocks_for(sizes))])
        host = torch.from_numpy(np.concatenate([
            np.array([r.data_ptr() for r in raws], np.uint64),
            np.array(sizes, np.uint64),
            prefix.astype(np.uint64)]).view(np.int64)).pin_memory()
        # the raw buffers stay alive with the batch: the table holds their
        # addresses, and a captured graph replays it
        self.raws, self.n, self.nblocks = raws, len(raws), int(prefix[-1])
        self.table = host.to(dev, non_blocking=True)
        self.partial = torch.empty(2 * self.nblocks, dtype=torch.int64,
                                   device=dev)
        self.out = torch.empty(self.n, dtype=torch.int64, device=dev)

    def launch(self) -> torch.Tensor:
        fn = _kernel()
        dev = self.out.device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(self.table.data_ptr(), self.n, self.nblocks,
                     self.partial.data_ptr(), self.out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"fletcher64 kernel launch failed: CUDA "
                               f"error {err}")
        fletcher64.launches += 1
        return self.out


def fletcher64_many_device(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel on CUDA tensors of one card: the checksums as an
    (n,) int64 tensor (the u64 bits) on that card, not yet read back."""
    return Batch(xs).launch()
