"""Bulk data layer (paper contribution C3).

The key Mercury idea for large arguments: the RPC message carries only a
*bulk descriptor* (registered-memory coordinates); the payload itself is
moved by one-sided put/get over the native transport, pipelined in chunks,
initiated by whichever side the service logic prefers (usually the target
pulls). This avoids serialization copies entirely and removes the size
limit of eager RPC messages.

``BulkHandle``   — local registered memory (possibly multi-segment).
``BulkDescriptor`` — the serializable remote view of a handle.
``bulk_transfer`` — pipelined one-sided GET/PUT between a local handle and
a remote descriptor, with segment-crossing offset resolution on both sides.
"""
from __future__ import annotations

import struct
import threading
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .na.base import NAAddress, NACap, NAMemHandle, NAPlugin
from .progress import Context
from .types import CallbackInfo, MercuryError, OpType, Ret

DEFAULT_CHUNK = 4 * 1024 * 1024
DEFAULT_INFLIGHT = 4


class BulkOpType(IntEnum):
    GET = 0   # remote -> local
    PUT = 1   # local -> remote


@dataclass
class BulkSegment:
    key: int
    size: int


@dataclass
class BulkDescriptor:
    """Serializable description of remote registered memory."""

    owner_uri: str
    segments: List[BulkSegment]
    read_allowed: bool = True
    write_allowed: bool = True

    @property
    def size(self) -> int:
        return sum(s.size for s in self.segments)

    # -- wire format ---------------------------------------------------------
    def to_bytes(self) -> bytes:
        uri = self.owner_uri.encode()
        out = struct.pack("<HBB", len(uri), int(self.read_allowed),
                          int(self.write_allowed)) + uri
        out += struct.pack("<I", len(self.segments))
        for s in self.segments:
            out += struct.pack("<QQ", s.key, s.size)
        return out

    @staticmethod
    def from_bytes(data: bytes | memoryview) -> "BulkDescriptor":
        data = memoryview(data)
        ulen, r, w = struct.unpack_from("<HBB", data)
        off = 4
        uri = bytes(data[off:off + ulen]).decode()
        off += ulen
        (nseg,) = struct.unpack_from("<I", data, off)
        off += 4
        segs = []
        for _ in range(nseg):
            key, size = struct.unpack_from("<QQ", data, off)
            off += 16
            segs.append(BulkSegment(key, size))
        return BulkDescriptor(uri, segs, bool(r), bool(w))


class BulkHandle:
    """Locally registered (possibly multi-segment) memory region."""

    def __init__(self, na: NAPlugin, buffers: Sequence[np.ndarray | memoryview | bytearray],
                 read: bool = True, write: bool = True):
        self.na = na
        self.buffers = list(buffers)
        self.mem: List[NAMemHandle] = [
            na.mem_register(b, read=read, write=write) for b in self.buffers
        ]
        self.read_allowed = read
        self.write_allowed = write

    @property
    def size(self) -> int:
        return sum(m.size for m in self.mem)

    def descriptor(self) -> BulkDescriptor:
        return BulkDescriptor(
            owner_uri=self.na.addr_self().uri,
            segments=[BulkSegment(m.key, m.size) for m in self.mem],
            read_allowed=self.read_allowed,
            write_allowed=self.write_allowed,
        )

    def free(self) -> None:
        for m in self.mem:
            self.na.mem_deregister(m)
        self.mem = []

    # -- segment resolution ----------------------------------------------------
    def _resolve(self, offset: int, size: int) -> List[Tuple[NAMemHandle, int, int]]:
        return _resolve_segments([(m, m.size) for m in self.mem], offset, size)


def _resolve_segments(segs: List[Tuple[object, int]], offset: int,
                      size: int) -> List[Tuple[object, int, int]]:
    """Map a flat (offset, size) range onto (segment, seg_off, length) pieces."""
    out = []
    pos = 0
    need = size
    for seg, seg_size in segs:
        if need == 0:
            break
        seg_start = pos
        seg_end = pos + seg_size
        pos = seg_end
        if offset >= seg_end:
            continue
        start_in_seg = max(0, offset - seg_start)
        avail = seg_size - start_in_seg
        take = min(avail, need)
        if take > 0:
            out.append((seg, start_in_seg, take))
            offset += take
            need -= take
    if need:
        raise MercuryError(Ret.INVALID_ARG,
                           f"bulk range [{offset}, +{need}) exceeds handle")
    return out


class BulkOp:
    """Tracks a pipelined multi-chunk transfer."""

    def __init__(self, total: int):
        self.total = total
        self.transferred = 0  #: guarded-by _lock
        self.ret = Ret.SUCCESS  #: guarded-by _lock
        self.canceled = False          # one-way latch; racy read is fine
        self._lock = threading.Lock()


def bulk_transfer(context: Context, op: BulkOpType, remote_addr: NAAddress,
                  remote: BulkDescriptor, remote_offset: int,
                  local: BulkHandle, local_offset: int, size: int,
                  cb: Optional[Callable[[CallbackInfo], None]] = None,
                  arg=None, chunk_size: int = DEFAULT_CHUNK,
                  max_inflight: int = DEFAULT_INFLIGHT) -> BulkOp:
    """One-sided pipelined transfer between ``local`` and ``remote``.

    GET pulls remote→local, PUT pushes local→remote. Chunks are issued up
    to ``max_inflight`` deep; completion posts a BULK entry on ``context``.
    """
    na = local.na
    if op == BulkOpType.GET and not remote.read_allowed:
        raise MercuryError(Ret.PERMISSION, "remote descriptor is not readable")
    if op == BulkOpType.PUT and not remote.write_allowed:
        raise MercuryError(Ret.PERMISSION, "remote descriptor is not writable")
    if size == 0:
        bop = BulkOp(0)
        context.completion_add(cb, CallbackInfo(OpType.BULK, Ret.SUCCESS,
                                                bulk_op=bop, arg=arg))
        return bop

    # Zero-copy fast path: when the plugin's put/get against this peer is a
    # native one-sided copy, chunking/pipelining only adds bookkeeping —
    # issue each contiguous segment pair as a single transfer.
    if na.caps_for(remote_addr) & NACap.NATIVE_RMA:
        chunk_size = max(chunk_size, size)

    local_pieces = local._resolve(local_offset, size)
    remote_segs = [(s, s.size) for s in remote.segments]
    remote_pieces = _resolve_segments(remote_segs, remote_offset, size)

    # Align local and remote piece lists into common (len-limited) chunks.
    chunks: List[Tuple[NAMemHandle, int, BulkSegment, int, int]] = []
    li = ri = 0
    lmem, loff, llen = local_pieces[0]
    rseg, roff, rlen = remote_pieces[0]
    while True:
        take = min(llen, rlen, chunk_size)
        chunks.append((lmem, loff, rseg, roff, take))
        loff += take; llen -= take
        roff += take; rlen -= take
        if llen == 0:
            li += 1
            if li < len(local_pieces):
                lmem, loff, llen = local_pieces[li]
        if rlen == 0:
            ri += 1
            if ri < len(remote_pieces):
                rseg, roff, rlen = remote_pieces[ri]
        if li >= len(local_pieces) or ri >= len(remote_pieces):
            break

    bop = BulkOp(size)
    state = {"next": 0, "outstanding": 0, "failed": None, "done": False}
    lock = threading.Lock()

    def finish(ret: Ret):
        with lock:
            if state["done"]:
                return
            state["done"] = True
        with bop._lock:
            bop.ret = ret
        context.completion_add(cb, CallbackInfo(OpType.BULK, ret,
                                                bulk_op=bop, arg=arg))

    def pump():
        while True:
            with lock:
                if state["failed"] is not None or bop.canceled:
                    if state["outstanding"] == 0:
                        pass
                    break
                if state["next"] >= len(chunks):
                    break
                if state["outstanding"] >= max_inflight:
                    break
                idx = state["next"]
                state["next"] += 1
                state["outstanding"] += 1
            lmem_i, loff_i, rseg_i, roff_i, n_i = chunks[idx]
            rmh = NAMemHandle(key=rseg_i.key, size=rseg_i.size,
                              owner_uri=remote.owner_uri,
                              read_allowed=remote.read_allowed,
                              write_allowed=remote.write_allowed)

            def on_chunk(ret: Ret, _n=n_i):
                with lock:
                    state["outstanding"] -= 1
                    if ret != Ret.SUCCESS:
                        state["failed"] = ret
                    failed = state["failed"]
                    outstanding = state["outstanding"]
                moved = -1
                if ret == Ret.SUCCESS:
                    with bop._lock:
                        bop.transferred += _n
                        moved = bop.transferred
                if moved == size:
                    finish(Ret.SUCCESS)
                elif failed is not None and outstanding == 0:
                    finish(failed)
                else:
                    pump()

            if op == BulkOpType.GET:
                na.get(lmem_i, loff_i, remote_addr, rmh, roff_i, n_i, on_chunk)
            else:
                na.put(lmem_i, loff_i, remote_addr, rmh, roff_i, n_i, on_chunk)

    pump()
    return bop


# -- convenience: expose ndarray pytrees -------------------------------------
def expose_arrays(na: NAPlugin, arrays: Sequence[np.ndarray],
                  read: bool = True, write: bool = True) -> BulkHandle:
    """Register a list of C-contiguous ndarrays as one multi-segment handle."""
    bufs = []
    for a in arrays:
        if not isinstance(a, np.ndarray):
            raise MercuryError(Ret.INVALID_ARG, "expose_arrays expects ndarrays")
        bufs.append(np.ascontiguousarray(a))
    return BulkHandle(na, bufs, read=read, write=write)
