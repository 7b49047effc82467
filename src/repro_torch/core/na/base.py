"""NA — the Network Abstraction layer (paper contribution C1).

Mercury's NA exposes *only* the minimal functionality an RPC layer needs,
which is what makes new fabric plugins cheap to write:

  * connectionless addressing  (``addr_lookup`` / ``addr_self``)
  * two-sided *unexpected* messages (small, unsolicited — RPC requests)
  * two-sided *expected* messages (pre-posted, tag-matched — responses)
  * one-sided RMA ``put``/``get`` against *registered memory* (bulk data)
  * a single ``progress`` entry point and per-op cancellation

Plugins implemented here:
  * ``self``  — in-process loopback (tests, benchmarks, co-located services)
  * ``sm``    — shared-memory rings + one-sided RMA over
                ``multiprocessing.shared_memory`` (same-host services)
  * ``tcp``   — real non-blocking sockets; RMA emulated with
                request/response chunks exactly like Mercury's tcp provider
On a real TPU cluster the host-side DCN uses ``tcp``; on-mesh (ICI) data
movement is compiled into XLA programs and is *not* routed through NA
(see DESIGN.md §2).
"""
from __future__ import annotations

import abc
import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..types import MercuryError, Ret, _Counter

# NA-level callbacks: cb(ret: Ret, **op specific kwargs)
NACallback = Callable[..., None]

UNEXPECTED_MSG_LIMIT = 64 * 1024   # eager limit for unexpected messages
EXPECTED_MSG_LIMIT = 16 * 1024 * 1024


class NACap(enum.IntFlag):
    """Capability flags a plugin advertises (checked by upper layers)."""

    NONE = 0
    NATIVE_RMA = 1       # put/get is one-sided for real: no target-side
                         # progress, no request/response emulation
    ZERO_COPY = 2        # put/get is a single direct copy into the
                         # destination buffer (no framing/staging copies)
    SAME_HOST = 4        # transport only reaches peers on this host
    SAME_PROCESS = 8     # transport only reaches peers in this process


# Locality tiers — lower is cheaper; used by multi-transport resolution.
TIER_SELF = 0    # same process
TIER_SM = 1      # same host (shared memory)
TIER_NET = 2     # network

SCHEME_TIERS = {"self": TIER_SELF, "sm": TIER_SM,
                "tcp": TIER_NET, "tcp-anon": TIER_NET}


class NAAddress(abc.ABC):
    """Opaque address. Plugins subclass; must be hashable and must expose a
    reconnectable ``uri`` (used when serializing bulk descriptors)."""

    uri: str

    def __hash__(self):
        return hash(self.uri)

    def __eq__(self, other):
        return isinstance(other, NAAddress) and other.uri == self.uri

    def __repr__(self):
        return f"<addr {self.uri}>"


@dataclass
class NAMemHandle:
    """Registered-memory handle.

    ``key`` is meaningful to the *owning* plugin instance; remote peers
    refer to the memory by ``(uri, key)``. ``local_buf`` is only populated
    on the owning side.
    """

    key: int
    size: int
    owner_uri: str
    read_allowed: bool = True
    write_allowed: bool = True
    local_buf: Optional[memoryview] = None  # not serialized
    sub: Optional[Dict[str, "NAMemHandle"]] = None  # multi-transport aliases


class NAOp:
    """Handle for an in-flight NA operation (cancelable)."""

    __slots__ = ("op_id", "kind", "canceled", "done", "user")

    def __init__(self, op_id: int, kind: str):
        self.op_id = op_id
        self.kind = kind
        self.canceled = False
        self.done = False
        self.user: Any = None

    def __repr__(self):
        st = "done" if self.done else ("canceled" if self.canceled else "pending")
        return f"<NAOp {self.kind} #{self.op_id} {st}>"


class NAPlugin(abc.ABC):
    """Minimal transport plugin interface (mirrors na_class_t ops)."""

    name: str = "abstract"
    caps: NACap = NACap.NONE
    tier: int = TIER_NET
    # eager-message limits (see DESIGN.md §3): senders exceeding these get
    # Ret.MSGSIZE; the RPC layer switches to rendezvous before hitting them.
    max_unexpected_size: int = UNEXPECTED_MSG_LIMIT
    max_expected_size: int = EXPECTED_MSG_LIMIT

    def __init__(self):
        self._op_counter = _Counter()
        self._mem_counter = _Counter()

    def caps_for(self, addr: "NAAddress") -> NACap:
        """Capabilities in effect when talking to ``addr`` (multi-transport
        plugins route this per destination)."""
        return self.caps

    def local_uris(self) -> List[str]:
        """URIs under which peers *in this process* reach this plugin
        with SAME_PROCESS semantics (the ``self`` tier).  The RPC layer
        uses these to register for serialization-free local dispatch
        (DESIGN.md §9); transports that cross a process boundary return
        the default empty list."""
        return []

    # -- staging buffers ------------------------------------------------------
    def alloc_msg_buffer(self, nbytes: int) -> Optional[np.ndarray]:
        """Optional transport-preferred staging memory for rendezvous
        payloads.  Plugins whose RMA needs special memory (sm: shm-backed
        segments reachable from other processes) return an array here;
        ``None`` means plain heap memory works (self, tcp)."""
        return None

    def free_msg_buffer(self, arr: np.ndarray) -> None:
        """Release a buffer from :meth:`alloc_msg_buffer` (no-op for
        buffers this plugin does not own)."""

    # -- addressing --------------------------------------------------------
    @abc.abstractmethod
    def addr_self(self) -> NAAddress: ...

    @abc.abstractmethod
    def addr_lookup(self, uri: str) -> NAAddress: ...

    # -- two-sided messaging ------------------------------------------------
    @abc.abstractmethod
    def msg_send_unexpected(self, dest: NAAddress, data, tag: int,
                            cb: NACallback) -> NAOp:
        """Send a small unsolicited message. ``data`` may be bytes or a
        tuple of buffers (vectored send — avoids payload concatenation on
        plugins with scatter/gather framing). cb(ret)."""

    @abc.abstractmethod
    def msg_recv_unexpected(self, cb: NACallback) -> NAOp:
        """Post a receive for *any* unexpected message.
        cb(ret, source: NAAddress, tag: int, data: memoryview)."""

    @abc.abstractmethod
    def msg_send_expected(self, dest: NAAddress, data, tag: int,
                          cb: NACallback) -> NAOp:
        """Send a tag-matched message (data: bytes or buffer tuple). cb(ret)."""

    @abc.abstractmethod
    def msg_recv_expected(self, source: Optional[NAAddress], tag: int,
                          cb: NACallback) -> NAOp:
        """Post a tag-matched receive. cb(ret, data: memoryview)."""

    # -- one-sided RMA -------------------------------------------------------
    @abc.abstractmethod
    def mem_register(self, buf: memoryview | np.ndarray,
                     read: bool = True, write: bool = True,
                     key: Optional[int] = None) -> NAMemHandle:
        """Register memory for one-sided access.  ``key`` lets a wrapping
        multi-transport plugin assign one key valid across transports."""

    @abc.abstractmethod
    def mem_deregister(self, mh: NAMemHandle) -> None: ...

    @abc.abstractmethod
    def put(self, local: NAMemHandle, local_off: int, dest: NAAddress,
            remote: NAMemHandle, remote_off: int, size: int,
            cb: NACallback) -> NAOp:
        """One-sided write local[off:off+size] -> remote[off:off+size]. cb(ret)."""

    @abc.abstractmethod
    def get(self, local: NAMemHandle, local_off: int, dest: NAAddress,
            remote: NAMemHandle, remote_off: int, size: int,
            cb: NACallback) -> NAOp:
        """One-sided read remote -> local. cb(ret)."""

    # -- progress ------------------------------------------------------------
    @abc.abstractmethod
    def progress(self, timeout: float) -> bool:
        """Drive the transport for up to ``timeout`` seconds. Returns True if
        any completion fired (callbacks run inside this call)."""

    @abc.abstractmethod
    def interrupt(self) -> None:
        """Wake a blocked progress() from another thread."""

    def cancel(self, op: NAOp) -> None:
        op.canceled = True

    def finalize(self) -> None:
        pass

    # -- helpers -------------------------------------------------------------
    def _new_op(self, kind: str) -> NAOp:
        return NAOp(self._op_counter.next(), kind)

    def _check_msg_size(self, data, limit: int, kind: str) -> int:
        """Enforce an eager-message limit; returns the flattened length."""
        if isinstance(data, tuple):
            n = sum(len(memoryview(d).cast("B")) for d in data)
        else:
            n = len(memoryview(data).cast("B"))
        if n > limit:
            raise MercuryError(
                Ret.MSGSIZE, f"{kind} message {n}B exceeds {self.name} "
                             f"limit {limit}B (use bulk RMA)")
        return n

    @staticmethod
    def as_view(buf) -> memoryview:
        if isinstance(buf, np.ndarray):
            if not buf.flags["C_CONTIGUOUS"]:
                raise MercuryError(Ret.INVALID_ARG, "buffer must be C-contiguous")
            return memoryview(buf).cast("B")
        return memoryview(buf).cast("B")
