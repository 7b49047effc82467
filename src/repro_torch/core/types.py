"""Core types shared across the Mercury-style RPC stack.

Mirrors the public surface of Mercury (hg_core): return codes, operation
types, headers.  Headers are fixed-size packed structs so that decoding an
incoming unexpected message is O(1) and allocation-free.
"""
from __future__ import annotations

import enum
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

PROTOCOL_VERSION = 5
MIN_PROTOCOL_VERSION = 4   # oldest peer version we still decode
HEADER_MAGIC = 0x4D4A5250  # "MJRP"
ZERO_TRACE_ID = b"\x00" * 16


class Ret(enum.IntEnum):
    """Return codes (subset of hg_return_t)."""

    SUCCESS = 0
    TIMEOUT = 1
    CANCELED = 2
    NOENTRY = 3          # RPC id not registered on target
    PROTOCOL_ERROR = 4
    CHECKSUM_ERROR = 5
    NOMEM = 6
    INVALID_ARG = 7
    FAULT = 8            # remote handler raised
    DISCONNECT = 9
    AGAIN = 10
    PERMISSION = 11
    MSGSIZE = 12         # message exceeds the transport's eager limit
    OVERLOAD = 13        # target shed the request (admission control):
                         # it cannot finish within the caller's deadline


class OpType(enum.IntEnum):
    """Completion-entry operation types (hg_cb_type)."""

    FORWARD = 0      # origin: response arrived (or send-only completed)
    RESPOND = 1      # target: response send completed
    BULK = 2         # bulk transfer completed
    LOOKUP = 3
    RPC_HANDLER = 4  # target: incoming RPC ready to execute
    SEND = 5
    RECV = 6


class MercuryError(Exception):
    def __init__(self, ret: Ret, msg: str = ""):
        self.ret = Ret(ret)
        super().__init__(f"{self.ret.name}: {msg}" if msg else self.ret.name)


class ChecksumError(MercuryError):
    def __init__(self, msg: str = ""):
        super().__init__(Ret.CHECKSUM_ERROR, msg)


# --------------------------------------------------------------------------
# Wire headers
# --------------------------------------------------------------------------
# Request v5 (64 B): magic u32 | version u8 | flags u8 | pad u16
#          | rpc_id u64 | cookie u64 | payload_len u32 | payload_crc u32
#          | budget_ms u32 (remaining deadline budget; 0 = unbounded)
#          | trace_id 16B | span_id u64 | trace_flags u8 | pad 3B
_REQ = struct.Struct("<IBBHQQIII16sQB3x")
# Request v4 (36 B): same prefix, no trace fields.  Still decoded for
# back-compat; a v4 peer's requests must keep working mid-upgrade.
_REQ_V4 = struct.Struct("<IBBHQQIII")
# Response: magic u32 | version u8 | ret u8 | pad u16 | cookie u64
#           | payload_len u32 | payload_crc u32
# Byte-identical across v4/v5 (responses carry no trace context: spans
# are collected server-side via dbg.trace) — only the version byte
# differs, and a target echoes the requester's version so a v4 peer's
# responses neither grow nor get rejected.
_RSP = struct.Struct("<IBBHQII")

REQUEST_HEADER_SIZE = _REQ.size
REQUEST_HEADER_SIZE_V4 = _REQ_V4.size
RESPONSE_HEADER_SIZE = _RSP.size


class Flags(enum.IntFlag):
    NONE = 0
    NO_RESPONSE = 1      # fire-and-forget RPC
    CHECKSUM = 2         # payload CRC is present/verified
    RENDEZVOUS = 4       # body is a bulk descriptor; target pulls the payload


@dataclass(frozen=True)
class RequestHeader:
    rpc_id: int
    cookie: int
    flags: Flags = Flags.NONE
    payload_len: int = 0
    payload_crc: int = 0
    # remaining deadline budget at send time, milliseconds; 0 = caller set
    # no deadline.  Targets use it for admission control (shed with
    # Ret.OVERLOAD when the estimated queue wait already exceeds it).
    budget_ms: int = 0
    # trace context (v5, DESIGN.md §10): zeroed = untraced request.  A v4
    # peer's header decodes with these left at their zero defaults.
    trace_id: bytes = ZERO_TRACE_ID
    span_id: int = 0
    trace_flags: int = 0
    # decoded wire version (v4 headers are shorter; targets echo this in
    # the response so old peers keep decoding us)
    version: int = PROTOCOL_VERSION

    @property
    def wire_size(self) -> int:
        """Actual on-wire size of this header (version-dependent) — the
        dispatcher slices the body at this offset, never at the constant."""
        return REQUEST_HEADER_SIZE_V4 if self.version == 4 \
            else REQUEST_HEADER_SIZE

    def pack(self) -> bytes:
        if self.version == 4:
            # legacy layout: trace fields dropped (tests and mixed-version
            # rings craft these; this process always sends v5)
            return _REQ_V4.pack(
                HEADER_MAGIC, 4, int(self.flags), 0,
                self.rpc_id, self.cookie, self.payload_len,
                self.payload_crc, self.budget_ms,
            )
        return _REQ.pack(
            HEADER_MAGIC, PROTOCOL_VERSION, int(self.flags), 0,
            self.rpc_id, self.cookie, self.payload_len, self.payload_crc,
            self.budget_ms, self.trace_id, self.span_id, self.trace_flags,
        )

    @staticmethod
    def unpack(buf: bytes | memoryview) -> "RequestHeader":
        magic, ver = struct.unpack_from("<IB", buf)
        if magic != HEADER_MAGIC:
            raise MercuryError(Ret.PROTOCOL_ERROR, f"bad magic {magic:#x}")
        if ver == PROTOCOL_VERSION:
            (_magic, _ver, flags, _pad, rpc_id, cookie, plen, crc, budget_ms,
             trace_id, span_id, trace_flags) = _REQ.unpack_from(buf)
            return RequestHeader(rpc_id, cookie, Flags(flags), plen, crc,
                                 budget_ms, bytes(trace_id), span_id,
                                 trace_flags, PROTOCOL_VERSION)
        if ver == 4:
            (_magic, _ver, flags, _pad, rpc_id, cookie, plen, crc,
             budget_ms) = _REQ_V4.unpack_from(buf)
            return RequestHeader(rpc_id, cookie, Flags(flags), plen, crc,
                                 budget_ms, version=4)
        raise MercuryError(
            Ret.PROTOCOL_ERROR,
            f"version {ver} unsupported (accept "
            f"{MIN_PROTOCOL_VERSION}..{PROTOCOL_VERSION})")


@dataclass(frozen=True)
class ResponseHeader:
    cookie: int
    ret: Ret = Ret.SUCCESS
    payload_len: int = 0
    payload_crc: int = 0
    # targets echo the requester's version; the layout is identical either
    # way, so v4 peers see responses of the exact size they expect
    version: int = PROTOCOL_VERSION

    def pack(self) -> bytes:
        return _RSP.pack(
            HEADER_MAGIC, self.version, int(self.ret), 0,
            self.cookie, self.payload_len, self.payload_crc,
        )

    @staticmethod
    def unpack(buf: bytes | memoryview) -> "ResponseHeader":
        magic, ver, ret, _pad, cookie, plen, crc = _RSP.unpack_from(buf)
        if magic != HEADER_MAGIC:
            raise MercuryError(Ret.PROTOCOL_ERROR, f"bad magic {magic:#x}")
        if not (MIN_PROTOCOL_VERSION <= ver <= PROTOCOL_VERSION):
            raise MercuryError(
                Ret.PROTOCOL_ERROR,
                f"version {ver} unsupported (accept "
                f"{MIN_PROTOCOL_VERSION}..{PROTOCOL_VERSION})")
        return ResponseHeader(cookie, Ret(ret), plen, crc, ver)


def payload_crc32(data: bytes | memoryview) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# Completion entries
# --------------------------------------------------------------------------
@dataclass
class CallbackInfo:
    """Passed to user callbacks when a completion entry is triggered
    (hg_cb_info)."""

    op_type: OpType
    ret: Ret
    # op-specific payloads:
    handle: Any = None        # Handle for FORWARD / RPC_HANDLER / RESPOND
    bulk_op: Any = None       # BulkOp for BULK
    arg: Any = None           # user arg given at post time


Callback = Callable[[CallbackInfo], None]


class _Counter:
    """Monotonic thread-safe u64 counter (cookies, op ids, mem keys)."""

    def __init__(self, start: int = 1):
        self._v = start  #: guarded-by _lock
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            v = self._v
            self._v = (self._v + 1) & 0xFFFFFFFFFFFFFFFF
            return v


def stable_rpc_id(name: str) -> int:
    """Stable 64-bit id for an RPC name (Mercury hashes the func name).

    CRC64-ish via two CRC32 passes; stable across processes/runs which is
    what matters for origin/target agreement.
    """
    b = name.encode()
    hi = zlib.crc32(b)
    lo = zlib.crc32(b[::-1] + b"\x9e")
    v = ((hi << 32) | lo) & 0xFFFFFFFFFFFFFFFF
    return v or 1
