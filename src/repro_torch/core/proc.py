"""Serialization ("proc") framework — Mercury's hg_proc equivalent.

A *proc* is a single function that either encodes or decodes a value
depending on the direction of the :class:`ProcBuf` it is given — the same
one-function-both-directions idiom Mercury uses so that argument encoders
cannot drift between the two directions.

    def proc_point(p: ProcBuf, v):
        x = proc_float64(p, v.x if p.encoding else None)
        y = proc_float64(p, v.y if p.encoding else None)
        return v if p.encoding else Point(x, y)

In practice users rarely hand-write procs: :func:`derive` builds one from
a dataclass's type hints, and combinators (:func:`list_of`,
:func:`optional`, :func:`dict_of`, ...) compose them.

Large binary payloads (ndarrays) have two paths, mirroring the paper's
eager/bulk split:
  * :func:`proc_ndarray` — inline (eager), for small arrays;
  * bulk descriptors (see ``core/bulk.py``) serialized with
    :func:`proc_bytes` — the RPC then carries only the descriptor and the
    target pulls the payload one-sidedly.
"""
from __future__ import annotations

import struct
import typing
from dataclasses import MISSING, fields, is_dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from .types import MercuryError, Ret

Proc = Callable[["ProcBuf", Any], Any]

# Copy-discipline thresholds (DESIGN.md §9).  Below ZEROCOPY_MIN a decoded
# bytes value is materialized as ``bytes`` (tiny, hashable, universally
# accepted); at or above it the decoder returns a read-only memoryview into
# the message buffer — zero copies, valid for the message's lifetime (every
# transport hands the RPC layer an owning buffer).  ENCODE_VIEW_MIN is the
# point at which ``encode`` stops flattening its bytearray into a fresh
# ``bytes`` (the second full-buffer copy) and returns a memoryview instead.
ZEROCOPY_MIN = 4096
ENCODE_VIEW_MIN = 64 * 1024


class ProcBuf:
    """Encode/decode cursor. ``encoding=True`` appends; else it consumes."""

    __slots__ = ("encoding", "_buf", "_view", "_pos")

    def __init__(self, encoding: bool, data: bytes | memoryview | None = None):
        self.encoding = encoding
        if encoding:
            self._buf = bytearray()
            self._view = None
        else:
            if data is None:
                raise MercuryError(Ret.INVALID_ARG, "decode ProcBuf needs data")
            self._buf = None
            self._view = memoryview(data)
        self._pos = 0

    # -- encode side -------------------------------------------------------
    def write(self, data: bytes | memoryview) -> None:
        self._buf += data

    def getvalue(self) -> bytes:
        return bytes(self._buf)

    def getbuffer(self) -> memoryview:
        """Zero-copy view of the encoded buffer.  The ProcBuf must not be
        written to while the view is exported (bytearray resize would
        raise BufferError) — callers take the view only once encoding is
        finished."""
        return memoryview(self._buf)

    # -- decode side -------------------------------------------------------
    def read(self, n: int) -> memoryview:
        if self._pos + n > len(self._view):
            raise MercuryError(
                Ret.PROTOCOL_ERROR,
                f"proc underflow: want {n} at {self._pos}, have {len(self._view)}",
            )
        out = self._view[self._pos : self._pos + n]
        self._pos += n
        return out

    def remaining(self) -> int:
        return 0 if self.encoding else len(self._view) - self._pos

    def done(self) -> bool:
        return self.encoding or self._pos == len(self._view)


def _scalar(fmt: str) -> Proc:
    st = struct.Struct("<" + fmt)

    def proc(p: ProcBuf, v=None):
        if p.encoding:
            p.write(st.pack(v))
            return v
        return st.unpack_from(p.read(st.size))[0]

    return proc


proc_uint8 = _scalar("B")
proc_uint16 = _scalar("H")
proc_uint32 = _scalar("I")
proc_uint64 = _scalar("Q")
proc_int8 = _scalar("b")
proc_int16 = _scalar("h")
proc_int32 = _scalar("i")
proc_int64 = _scalar("q")
proc_float32 = _scalar("f")
proc_float64 = _scalar("d")


def proc_bool(p: ProcBuf, v=None):
    if p.encoding:
        p.write(b"\x01" if v else b"\x00")
        return v
    return p.read(1)[0] != 0


def proc_varint(p: ProcBuf, v=None):
    """LEB128 unsigned varint — compact lengths on the wire."""
    if p.encoding:
        n = int(v)
        if n < 0:
            raise MercuryError(Ret.INVALID_ARG, "varint must be >= 0")
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                break
        p.write(out)
        return v
    shift, n = 0, 0
    while True:
        b = p.read(1)[0]
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n
        shift += 7
        if shift > 63:
            raise MercuryError(Ret.PROTOCOL_ERROR, "varint overflow")


def proc_bytes(p: ProcBuf, v=None):
    if p.encoding:
        proc_varint(p, len(v))
        p.write(v)
        return v
    n = proc_varint(p)
    if n < ZEROCOPY_MIN:
        return bytes(p.read(n))
    # large payload: hand back a read-only view into the message buffer
    # (no copy).  Read-only keeps it hashable and content-comparable with
    # bytes; callers needing an owning copy do bytes(view) explicitly.
    return p.read(n).toreadonly()


def proc_str(p: ProcBuf, v=None):
    if p.encoding:
        proc_bytes(p, v.encode("utf-8"))
        return v
    # decode straight from the buffer view: one copy (the str), not two
    n = proc_varint(p)
    return str(p.read(n), "utf-8")


def proc_none(p: ProcBuf, v=None):
    return None


# --------------------------------------------------------------------------
# ndarray (inline / eager path)
# --------------------------------------------------------------------------
def proc_ndarray(p: ProcBuf, v: Optional[np.ndarray] = None):
    """Inline ndarray: dtype str | ndim | shape... | raw bytes (C order).

    Decoding is zero-copy when the source buffer permits (returns an array
    viewing the message buffer; callers own the message lifetime).
    """
    if p.encoding:
        a = np.ascontiguousarray(v)
        proc_str(p, a.dtype.str)
        proc_varint(p, a.ndim)
        for d in a.shape:
            proc_varint(p, d)
        p.write(memoryview(a).cast("B"))
        return v
    dt = np.dtype(proc_str(p))
    ndim = proc_varint(p)
    shape = tuple(proc_varint(p) for _ in range(ndim))
    nbytes = dt.itemsize * int(np.prod(shape)) if shape else dt.itemsize * 1
    count = int(np.prod(shape)) if shape else 1
    raw = p.read(count * dt.itemsize)
    arr = np.frombuffer(raw, dtype=dt, count=count).reshape(shape)
    return arr


# --------------------------------------------------------------------------
# Combinators
# --------------------------------------------------------------------------
def list_of(item: Proc) -> Proc:
    def proc(p: ProcBuf, v=None):
        if p.encoding:
            proc_varint(p, len(v))
            for it in v:
                item(p, it)
            return v
        n = proc_varint(p)
        return [item(p) for _ in range(n)]

    return proc


def tuple_of(*items: Proc) -> Proc:
    def proc(p: ProcBuf, v=None):
        if p.encoding:
            if len(v) != len(items):
                raise MercuryError(Ret.INVALID_ARG, "tuple arity mismatch")
            for it, x in zip(items, v):
                it(p, x)
            return v
        return tuple(it(p) for it in items)

    return proc


def dict_of(key: Proc, val: Proc) -> Proc:
    def proc(p: ProcBuf, v=None):
        if p.encoding:
            proc_varint(p, len(v))
            for k in v:
                key(p, k)
                val(p, v[k])
            return v
        n = proc_varint(p)
        return {key(p): val(p) for _ in range(n)}

    return proc


def optional(item: Proc) -> Proc:
    def proc(p: ProcBuf, v=None):
        if p.encoding:
            proc_bool(p, v is not None)
            if v is not None:
                item(p, v)
            return v
        return item(p) if proc_bool(p) else None

    return proc


# --------------------------------------------------------------------------
# Dataclass derivation
# --------------------------------------------------------------------------
_ATOM_PROCS: Dict[Any, Proc] = {
    int: proc_int64,
    float: proc_float64,
    bool: proc_bool,
    str: proc_str,
    bytes: proc_bytes,
    np.ndarray: proc_ndarray,
    type(None): proc_none,
}

_derived_cache: Dict[type, Proc] = {}


def register_atom(tp: type, proc: Proc) -> None:
    """Let upper layers plug custom wire types (paper C6: serialization may
    be provided by upper layers)."""
    _ATOM_PROCS[tp] = proc


def proc_for(tp: Any) -> Proc:
    """Resolve a proc for a type annotation."""
    if tp in _ATOM_PROCS:
        return _ATOM_PROCS[tp]
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin in (list, List):
        return list_of(proc_for(args[0]))
    if origin in (dict, Dict):
        return dict_of(proc_for(args[0]), proc_for(args[1]))
    if origin in (tuple, Tuple):
        if len(args) == 2 and args[1] is Ellipsis:
            inner = list_of(proc_for(args[0]))

            def proc_vtuple(p, v=None, _inner=inner):
                if p.encoding:
                    _inner(p, list(v))
                    return v
                return tuple(_inner(p))

            return proc_vtuple
        return tuple_of(*(proc_for(a) for a in args))
    if origin is typing.Union:
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == 1 and len(args) == 2:
            return optional(proc_for(non_none[0]))
        raise MercuryError(Ret.INVALID_ARG, f"unsupported Union {tp}")
    if is_dataclass(tp):
        return derive(tp)
    raise MercuryError(Ret.INVALID_ARG, f"no proc for type {tp!r}")


def derive(cls: type) -> Proc:
    """Derive a proc for a dataclass from its type hints (cached)."""
    if cls in _derived_cache:
        return _derived_cache[cls]
    if not is_dataclass(cls):
        raise MercuryError(Ret.INVALID_ARG, f"{cls} is not a dataclass")

    # placeholder to allow recursive types
    def _placeholder(p, v=None):
        return _derived_cache[cls](p, v)

    _derived_cache[cls] = _placeholder
    hints = typing.get_type_hints(cls)
    field_procs = [(f.name, proc_for(hints[f.name])) for f in fields(cls)]

    def proc(p: ProcBuf, v=None):
        if p.encoding:
            for name, fp in field_procs:
                fp(p, getattr(v, name))
            return v
        return cls(**{name: fp(p) for name, fp in field_procs})

    _derived_cache[cls] = proc
    return proc


# --------------------------------------------------------------------------
# Convenience entry points used by rpc.py
# --------------------------------------------------------------------------
def encode(proc: Proc, value: Any) -> bytes | memoryview:
    p = ProcBuf(encoding=True)
    proc(p, value)
    # fast path: past ENCODE_VIEW_MIN the flatten-to-bytes costs a second
    # full-buffer copy; return a view of the (now write-complete) buffer
    # instead.  Small messages stay bytes — cheap, and senders concatenate
    # them freely.
    if len(p._buf) >= ENCODE_VIEW_MIN:
        return p.getbuffer()
    return p.getvalue()


def decode(proc: Proc, data: bytes | memoryview) -> Any:
    p = ProcBuf(encoding=False, data=data)
    v = proc(p)
    return v


# A permissive default proc for ad-hoc python values (tagged union).
def proc_any(p: ProcBuf, v=None):
    """Self-describing proc for JSON-ish python values + ndarray/bytes.

    Used as the default in/out proc so services can pass plain dicts
    without declaring dataclasses; hot paths should declare real procs.
    """
    TAGS = {type(None): 0, bool: 1, int: 2, float: 3, str: 4, bytes: 5,
            list: 6, tuple: 7, dict: 8, np.ndarray: 9}
    if p.encoding:
        t = type(v)
        if isinstance(v, np.ndarray):
            t = np.ndarray
        elif isinstance(v, bool):
            t = bool  # before int: bool is an int subclass
        elif isinstance(v, (np.integer,)):
            v, t = int(v), int
        elif isinstance(v, (np.floating,)):
            v, t = float(v), float
        elif isinstance(v, (memoryview, bytearray)):
            t = bytes  # zero-copy decoded views re-encode as bytes
        if t not in TAGS:
            raise MercuryError(Ret.INVALID_ARG, f"proc_any: {t}")
        proc_uint8(p, TAGS[t])
        if t is type(None):
            pass
        elif t is bool:
            proc_bool(p, v)
        elif t is int:
            proc_int64(p, v)
        elif t is float:
            proc_float64(p, v)
        elif t is str:
            proc_str(p, v)
        elif t is bytes:
            proc_bytes(p, v)
        elif t in (list, tuple):
            proc_varint(p, len(v))
            for it in v:
                proc_any(p, it)
        elif t is dict:
            proc_varint(p, len(v))
            for k, val in v.items():
                proc_any(p, k)
                proc_any(p, val)
        elif t is np.ndarray:
            proc_ndarray(p, v)
        return v
    tag = proc_uint8(p)
    if tag == 0:
        return None
    if tag == 1:
        return proc_bool(p)
    if tag == 2:
        return proc_int64(p)
    if tag == 3:
        return proc_float64(p)
    if tag == 4:
        return proc_str(p)
    if tag == 5:
        return proc_bytes(p)
    if tag in (6, 7):
        n = proc_varint(p)
        xs = [proc_any(p) for _ in range(n)]
        return xs if tag == 6 else tuple(xs)
    if tag == 8:
        n = proc_varint(p)
        return {proc_any(p): proc_any(p) for _ in range(n)}
    if tag == 9:
        return proc_ndarray(p)
    raise MercuryError(Ret.PROTOCOL_ERROR, f"proc_any: bad tag {tag}")
