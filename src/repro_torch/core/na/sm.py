"""``sm`` NA plugin — same-host shared-memory transport.

Two-sided messaging runs over per-connection SPSC byte rings living in
``multiprocessing.shared_memory`` segments; a named-FIFO doorbell per
instance gives blocking ``progress()`` without busy-polling.  One-sided
RMA is *native* (NACap.NATIVE_RMA | ZERO_COPY): ``put``/``get`` are a
single direct copy into the destination buffer, performed entirely by the
initiator — the target's progress loop is never involved:

  * peer in this process  → copy via the process-local instance registry;
  * peer in another process → the owner published the registration in the
    *memdir* table of its control segment (key → segment name/offset);
    the initiator attaches that segment and copies.

Cross-process RMA therefore requires shm-backed registered memory — use
:meth:`SMPlugin.alloc_array` — while plain ndarrays still get zero-copy
RMA against peers in the same process.  See DESIGN.md §4.

Wire layout (all little-endian):
  control segment  — magic | uri | peer-slot table | memdir
  conn segment     — magic | connector uri | ring A→B | ring B→A
  ring             — head u64 | tail u64 | producer-waiting u8 | data
  frame            — total u32 | kind u8 | tag u64 | payload

Connection setup: the connector creates the conn segment, then claims a
free slot in the listener's control segment under an ``flock`` (the only
cross-process lock; the data path is lock-free SPSC) and rings the
listener's doorbell.
"""
from __future__ import annotations

import errno
import fcntl
import hashlib
import os
import selectors
import socket
import struct
import tempfile
import threading
import uuid
from collections import deque
from multiprocessing import resource_tracker, shared_memory
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..types import MercuryError, Ret, _Counter
from .base import (NAAddress, NACallback, NACap, NAMemHandle, NAOp, NAPlugin,
                   TIER_SM, UNEXPECTED_MSG_LIMIT)

CTL_MAGIC = 0x534D4354
CONN_MAGIC = 0x534D434E

_URI_MAX = 255
_URI_OFF = 8                       # u16 len + bytes
_SLOTS_OFF = _URI_OFF + 2 + _URI_MAX + 7
N_SLOTS = 64
SLOT_SZ = 4 + _URI_MAX + 1         # state u8, pad, len u16, name
_MEMDIR_OFF = _SLOTS_OFF + N_SLOTS * SLOT_SZ
MEMDIR_ENTRIES = 128
_ENT = struct.Struct("<BxxxxxxxQQQBxH")   # state, key, off, size, flags, nlen
ENT_SZ = _ENT.size + _URI_MAX + 1
CTL_SIZE = _MEMDIR_OFF + MEMDIR_ENTRIES * ENT_SZ

RING_HDR = 32                      # head u64, tail u64, waiting u8, pad
RING_CAP = 4 * 1024 * 1024
_CONN_RINGS_OFF = _URI_OFF + 2 + _URI_MAX + 7
CONN_SIZE = _CONN_RINGS_OFF + 2 * (RING_HDR + RING_CAP)

_FRAME = struct.Struct("<IBQ")     # total (kind+tag+payload), kind, tag
K_UNEXP = 1
K_EXP = 2

_U64 = struct.Struct("<Q")

# process-local instance registry: in-process RMA fast path + uri probing
_PROCESS: Dict[str, "SMPlugin"] = {}  #: guarded-by _PROCESS_LOCK
_PROCESS_LOCK = threading.Lock()


def _digest(uri: str) -> str:
    return hashlib.sha1(uri.encode()).hexdigest()[:16]


def _rundir() -> str:
    d = os.path.join(tempfile.gettempdir(), "mjrp-sm")
    os.makedirs(d, exist_ok=True)
    return d


def _close_seg(shm: shared_memory.SharedMemory, unlink: bool = False) -> None:
    try:
        shm.close()
    except BufferError:
        pass                    # user-held views (alloc_array) keep it mapped
    if unlink:
        try:
            shm.unlink()
        except FileNotFoundError:
            pass


_CREATED_HERE: set = set()          # segment names this process created


def _create(name: str, size: int) -> shared_memory.SharedMemory:
    shm = shared_memory.SharedMemory(name=name, create=True, size=size)
    _CREATED_HERE.add(shm.name)
    return shm


def _attach(name: str) -> shared_memory.SharedMemory:
    """Attach a segment without letting resource_tracker unlink it when
    *this* process exits (CPython registers on attach too — bpo-39959).
    Segments created by this very process keep their registration: the
    creator's unlink() is what balances it."""
    shm = shared_memory.SharedMemory(name=name)
    if shm.name not in _CREATED_HERE:
        try:
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
    return shm


def _put_str(mv: memoryview, off: int, s: str) -> None:
    b = s.encode()
    if len(b) > _URI_MAX:
        raise MercuryError(Ret.INVALID_ARG, f"uri too long: {s}")
    struct.pack_into("<H", mv, off, len(b))
    mv[off + 2:off + 2 + len(b)] = b


def _get_str(mv: memoryview, off: int) -> str:
    (n,) = struct.unpack_from("<H", mv, off)
    return bytes(mv[off + 2:off + 2 + n]).decode()


class SMAddress(NAAddress):
    def __init__(self, uri: str):
        self.uri = uri


class _Ring:
    """SPSC circular byte ring over a segment slice.  The producer owns
    ``head``, the consumer owns ``tail``; both are monotonically
    increasing u64s, so no modular ambiguity between full and empty."""

    __slots__ = ("mv", "base", "cap", "data")

    def __init__(self, mv: memoryview, base: int, cap: int = RING_CAP):
        self.mv = mv
        self.base = base
        self.cap = cap
        self.data = mv[base + RING_HDR:base + RING_HDR + cap]

    @property
    def head(self) -> int:
        return _U64.unpack_from(self.mv, self.base)[0]

    @head.setter
    def head(self, v: int) -> None:
        _U64.pack_into(self.mv, self.base, v)

    @property
    def tail(self) -> int:
        return _U64.unpack_from(self.mv, self.base + 8)[0]

    @tail.setter
    def tail(self, v: int) -> None:
        _U64.pack_into(self.mv, self.base + 8, v)

    @property
    def waiting(self) -> bool:
        return self.mv[self.base + 16] != 0

    @waiting.setter
    def waiting(self, v: bool) -> None:
        self.mv[self.base + 16] = 1 if v else 0

    def _copy_in(self, pos: int, data) -> None:
        pos %= self.cap
        first = min(len(data), self.cap - pos)
        self.data[pos:pos + first] = data[:first]
        if first < len(data):
            self.data[:len(data) - first] = data[first:]

    def _copy_out(self, pos: int, n: int) -> bytes:
        pos %= self.cap
        first = min(n, self.cap - pos)
        out = bytes(self.data[pos:pos + first])
        if first < n:
            out += bytes(self.data[:n - first])
        return out

    def try_write(self, frame: bytes) -> bool:
        head = self.head
        if self.cap - (head - self.tail) < len(frame):
            return False
        self._copy_in(head, frame)
        self.head = head + len(frame)      # publish after the data lands
        return True

    def try_read(self) -> Optional[Tuple[int, int, bytes]]:
        tail = self.tail
        if self.head - tail < _FRAME.size:
            return None
        total, kind, tag = _FRAME.unpack(self._copy_out(tail, _FRAME.size))
        payload = self._copy_out(tail + _FRAME.size, total - 9)
        self.tail = tail + _FRAME.size + total - 9
        return kind, tag, payload

    def release(self) -> None:
        self.data.release()


class _SMConn:
    __slots__ = ("shm", "tx", "rx", "peer_uri", "bell_fd", "backlog",
                 "owner", "closed")

    def __init__(self, shm: shared_memory.SharedMemory, tx: _Ring, rx: _Ring,
                 peer_uri: str, bell_fd: int, owner: bool):
        self.shm = shm
        self.tx = tx
        self.rx = rx
        self.peer_uri = peer_uri
        self.bell_fd = bell_fd
        self.backlog: Deque[bytes] = deque()
        self.owner = owner
        self.closed = False


class SMPlugin(NAPlugin):
    name = "sm"
    caps = NACap.NATIVE_RMA | NACap.ZERO_COPY | NACap.SAME_HOST
    tier = TIER_SM
    max_unexpected_size = UNEXPECTED_MSG_LIMIT
    max_expected_size = RING_CAP - 64

    def __init__(self, uri: Optional[str] = None):
        super().__init__()
        if uri is None:
            uri = f"sm://p{os.getpid()}-{uuid.uuid4().hex[:8]}"
        elif not uri.startswith("sm://"):
            uri = "sm://" + uri
        self._uri = uri
        self._digest = _digest(uri)
        self._lock = threading.Lock()
        self._pending: Deque = deque()  #: guarded-by _lock

        # control segment + doorbell, all inside the connect lock: stale
        # takeover must not race a second process claiming the same uri,
        # and the segment/FIFO must be fully initialized before anyone
        # probing under the lock can see them (a half-written ctl would
        # read as stale or corrupt).
        self._bell_path = os.path.join(_rundir(), self._digest + ".bell")
        lfd = os.open(os.path.join(_rundir(), self._digest + ".lock"),
                      os.O_CREAT | os.O_RDWR, 0o600)
        try:
            fcntl.flock(lfd, fcntl.LOCK_EX)
            try:
                self._ctl = _create(f"mjrp-ct-{self._digest}", CTL_SIZE)
            except FileExistsError:
                if not self._uri_is_stale():
                    raise MercuryError(Ret.INVALID_ARG, f"sm uri in use: {uri}")
                # crashed predecessor: reclaim its name
                try:
                    old = shared_memory.SharedMemory(
                        name=f"mjrp-ct-{self._digest}")
                    old.close()
                    old.unlink()
                except FileNotFoundError:
                    pass
                try:
                    os.unlink(self._bell_path)
                except OSError:
                    pass
                self._ctl = _create(f"mjrp-ct-{self._digest}", CTL_SIZE)
            mv = self._ctl.buf
            mv[:CTL_SIZE] = b"\x00" * CTL_SIZE
            struct.pack_into("<IB", mv, 0, CTL_MAGIC, 1)
            _put_str(mv, _URI_OFF, uri)
            try:
                os.mkfifo(self._bell_path)
            except FileExistsError:
                pass
            # O_RDWR (not O_RDONLY): with a read-only fd the FIFO latches
            # EOF once the last writer closes and the selector reports it
            # readable forever — a 100% CPU busy-spin.  Keeping our own
            # writer open means reads just return EAGAIN.  (Liveness
            # probing still works: this fd is also the FIFO's reader, and
            # it closes when this process dies.)
            self._bell_r = os.open(self._bell_path,
                                   os.O_RDWR | os.O_NONBLOCK)
        finally:
            fcntl.flock(lfd, fcntl.LOCK_UN)
            os.close(lfd)
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_pending = False      # suppress redundant wake syscalls
        self._scan_slots = True         # scan peer slots on doorbell only
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._bell_r, selectors.EVENT_READ, "bell")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")

        # messaging state. Unlike tcp, the *send* path needs no selector,
        # so senders write rings directly from their own thread under
        # _tx_lock (one fewer handoff per hop — the shm latency win);
        # receive-side state stays owned by the progress thread.
        self._tx_lock = threading.Lock()
        self._conns: Dict[str, _SMConn] = {}  #: guarded-by _tx_lock
        # doorbell-coalescing counters (under _tx_lock on the send path):
        # bells/frames ≪ 1 under burst is the win bench_core asserts
        self.stat_frames = 0  #: guarded-by _tx_lock
        self.stat_bells = 0  #: guarded-by _tx_lock
        self._recv_unexpected: Deque[Tuple[NAOp, NACallback]] = deque()
        self._in_unexpected: Deque[Tuple[str, int, memoryview]] = deque()
        self._recv_expected: List[Tuple[NAOp, Optional[str], int, NACallback]] = []
        self._in_expected: Deque[Tuple[str, int, memoryview]] = deque()
        self._completions: Deque[Tuple[NAOp, NACallback, Tuple]] = deque()

        # RMA state (shared with caller threads → _lock)
        self._mem: Dict[int, Tuple[memoryview, bool, bool, Optional[int]]] = {}  #: guarded-by _lock
        self._allocs: List[Tuple[str, shared_memory.SharedMemory, int, int]] = []  #: guarded-by _lock
        self._peer_ctls: Dict[str, shared_memory.SharedMemory] = {}  #: guarded-by _lock
        self._finalized = False

        with _PROCESS_LOCK:
            _PROCESS[uri] = self

    def _uri_is_stale(self) -> bool:
        """True when the ctl segment's owner is gone: its doorbell FIFO has
        no reader (or no FIFO at all)."""
        path = os.path.join(_rundir(), self._digest + ".bell")
        with _PROCESS_LOCK:
            if self._uri in _PROCESS:       # alive in this very process
                return False
        try:
            fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
        except FileNotFoundError:
            return True
        except OSError as e:
            return e.errno == errno.ENXIO   # no reader on the FIFO
        os.close(fd)
        return False

    # -- addressing ----------------------------------------------------------
    def addr_self(self) -> NAAddress:
        return SMAddress(self._uri)

    def addr_lookup(self, uri: str) -> NAAddress:
        if not uri.startswith("sm://"):
            raise MercuryError(Ret.INVALID_ARG, f"not an sm uri: {uri}")
        self._peer_ctl(uri)            # reachability probe (same host only)
        return SMAddress(uri)

    def _peer_ctl(self, uri: str) -> memoryview:
        if uri == self._uri:
            return self._ctl.buf
        with self._lock:
            shm = self._peer_ctls.get(uri)
        if shm is None:
            # attach outside the lock (filesystem work), then publish with a
            # double-check: the loser of a concurrent attach closes its copy
            try:
                shm = _attach(f"mjrp-ct-{_digest(uri)}")
            except FileNotFoundError:
                raise MercuryError(Ret.DISCONNECT, f"no sm listener at {uri}")
            if struct.unpack_from("<I", shm.buf, 0)[0] != CTL_MAGIC:
                shm.close()
                raise MercuryError(Ret.PROTOCOL_ERROR, f"bad sm segment: {uri}")
            with self._lock:
                winner = self._peer_ctls.setdefault(uri, shm)
            if winner is not shm:
                _close_seg(shm)
                shm = winner
        return shm.buf

    # -- cross-thread posting -------------------------------------------------
    def _post(self, fn) -> None:
        with self._lock:
            self._pending.append(fn)
        self.interrupt()

    def interrupt(self) -> None:
        if self._wake_pending:
            return                      # a byte is already in flight
        self._wake_pending = True
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def _ring_bell(self, fd: int) -> bool:
        """Ring a peer's doorbell; False means the peer is gone (its FIFO
        lost its reader — the EPIPE doubles as liveness detection)."""
        try:
            os.write(fd, b"\x00")
            return True
        except BlockingIOError:
            return True                 # full FIFO already wakes the peer
        except OSError as e:
            return e.errno != errno.EPIPE

    # -- connection management (any thread; guarded by _tx_lock) --------------
    def _open_peer_bell(self, peer_uri: str) -> int:
        path = os.path.join(_rundir(), _digest(peer_uri) + ".bell")
        try:
            return os.open(path, os.O_WRONLY | os.O_NONBLOCK)
        except OSError:
            raise MercuryError(Ret.DISCONNECT, f"no sm doorbell at {peer_uri}")

    def _connect_locked(self, uri: str) -> _SMConn:
        if self._finalized:
            raise MercuryError(Ret.DISCONNECT, "sm plugin finalized")
        conn = self._conns.get(uri)
        if conn and not conn.closed:
            return conn
        ctl = self._peer_ctl(uri)
        seg = _create(f"mjrp-cn-{uuid.uuid4().hex[:16]}", CONN_SIZE)
        conn = None
        try:
            mv = seg.buf
            mv[:_CONN_RINGS_OFF] = b"\x00" * _CONN_RINGS_OFF
            for base in (_CONN_RINGS_OFF,
                         _CONN_RINGS_OFF + RING_HDR + RING_CAP):
                mv[base:base + RING_HDR] = b"\x00" * RING_HDR
            struct.pack_into("<IB", mv, 0, CONN_MAGIC, 1)
            _put_str(mv, _URI_OFF, self._uri)
            bell_fd = self._open_peer_bell(uri)
            conn = _SMConn(seg,
                           tx=_Ring(mv, _CONN_RINGS_OFF),
                           rx=_Ring(mv, _CONN_RINGS_OFF + RING_HDR + RING_CAP),
                           peer_uri=uri, bell_fd=bell_fd, owner=True)
            # claim a peer slot under the connect lock (the only x-proc lock)
            lock_path = os.path.join(_rundir(), _digest(uri) + ".lock")
            lfd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o600)
            try:
                fcntl.flock(lfd, fcntl.LOCK_EX)
                for i in range(N_SLOTS):
                    off = _SLOTS_OFF + i * SLOT_SZ
                    if ctl[off] == 0:
                        _put_str(ctl, off + 2, seg.name)
                        ctl[off] = 1   # publish after the name is written
                        break
                else:
                    raise MercuryError(Ret.NOMEM,
                                       f"sm peer slots full at {uri}")
            finally:
                fcntl.flock(lfd, fcntl.LOCK_UN)
                os.close(lfd)
        except BaseException:
            if conn is not None:
                conn.tx.release()
                conn.rx.release()
                try:
                    os.close(conn.bell_fd)
                except OSError:
                    pass
            _close_seg(seg, unlink=True)
            raise
        self._conns[uri] = conn
        if not self._ring_bell(bell_fd):
            self._drop_conn_locked(conn)
            raise MercuryError(Ret.DISCONNECT, f"sm peer {uri} is gone")
        return conn

    def _accept_new(self) -> None:
        """Scan our slot table for freshly posted connections."""
        mv = self._ctl.buf
        for i in range(N_SLOTS):
            off = _SLOTS_OFF + i * SLOT_SZ
            if mv[off] != 1:
                continue
            name = _get_str(mv, off + 2)
            mv[off] = 0        # announcement consumed: slot reusable
            try:
                seg = _attach(name)
            except FileNotFoundError:
                continue
            peer_uri = _get_str(seg.buf, _URI_OFF)
            try:
                bell_fd = self._open_peer_bell(peer_uri)
            except MercuryError:
                seg.close()
                continue
            conn = _SMConn(
                seg,
                tx=_Ring(seg.buf, _CONN_RINGS_OFF + RING_HDR + RING_CAP),
                rx=_Ring(seg.buf, _CONN_RINGS_OFF),
                peer_uri=peer_uri, bell_fd=bell_fd, owner=False)
            with self._tx_lock:
                self._conns.setdefault(peer_uri, conn)
                if self._conns[peer_uri] is not conn:
                    # simultaneous connect: keep both data paths alive by
                    # draining this one too, under an aliased key
                    self._conns[f"{peer_uri}#{i}"] = conn

    def _drop_conn_locked(self, conn: _SMConn) -> None:
        """Tear down a connection whose peer is gone (called under
        _tx_lock); also invalidates the cached peer ctl so the next
        connect re-resolves a (possibly restarted) listener."""
        if conn.closed:
            return
        conn.closed = True
        conn.backlog.clear()
        try:
            os.close(conn.bell_fd)
        except OSError:
            pass
        conn.tx.release()
        conn.rx.release()
        _close_seg(conn.shm, unlink=conn.owner)
        for k in [k for k, c in self._conns.items() if c is conn]:
            del self._conns[k]
        with self._lock:
            stale_ctl = self._peer_ctls.pop(conn.peer_uri, None)
        if stale_ctl is not None:
            _close_seg(stale_ctl)

    def _enqueue_frame_locked(self, conn: _SMConn, kind: int, tag: int,
                       payload: bytes) -> None:
        frame = _FRAME.pack(len(payload) + 9, kind, tag) + payload
        if len(frame) > conn.tx.cap - 1:
            raise MercuryError(Ret.MSGSIZE,
                               f"frame {len(frame)}B exceeds sm ring")
        # Doorbell coalescing: one FIFO byte per idle→busy transition,
        # not per frame.  Sampled BEFORE our write lands — if the ring
        # already holds unconsumed frames (or a backlog is draining), a
        # previous bell is still pending for the peer and another byte is
        # pure syscall overhead.  Under an N-frame burst this collapses N
        # writes into ~1.  Races where the peer drains the ring between
        # our sample and our write are bounded by the multiplexer's 5ms
        # progress slice (core/na/multi.py) — progress() always drains
        # every conn, bell byte or not.
        was_idle = not conn.backlog and conn.tx.head == conn.tx.tail
        self.stat_frames += 1
        if conn.backlog or not conn.tx.try_write(frame):
            conn.backlog.append(frame)
            conn.tx.waiting = True
            # ring full: always ring — the bell doubles as the liveness
            # probe (EPIPE ⇒ peer gone) and a stalled consumer must not
            # be left unprodded while we hold a growing backlog
            was_idle = True
        if was_idle:
            self.stat_bells += 1
            if not self._ring_bell(conn.bell_fd):
                self._drop_conn_locked(conn)
                raise MercuryError(Ret.DISCONNECT,
                                   f"sm peer {conn.peer_uri} is gone")

    def _flush_backlog_locked(self, conn: _SMConn) -> None:
        wrote = False
        while conn.backlog and conn.tx.try_write(conn.backlog[0]):
            conn.backlog.popleft()
            wrote = True
        if not conn.backlog:
            conn.tx.waiting = False
        if wrote:
            self.stat_bells += 1        # one bell per flush, not per frame
            if not self._ring_bell(conn.bell_fd):
                self._drop_conn_locked(conn)

    # -- messaging API ---------------------------------------------------------
    def _send(self, kind: str, wire_kind: int, dest, data, tag, cb,
              limit: int) -> NAOp:
        self._check_msg_size(data, limit, kind)
        op = self._new_op(f"send_{kind}")
        flat = b"".join(bytes(memoryview(d).cast("B")) for d in data) \
            if isinstance(data, tuple) else bytes(memoryview(data).cast("B"))

        # write the ring from the caller's thread: the shm send path needs
        # no selector, so the message lands before the peer's next wakeup
        try:
            with self._tx_lock:
                conn = self._connect_locked(dest.uri)
                self._enqueue_frame_locked(conn, wire_kind, tag, flat)
            ret = Ret.SUCCESS
        except MercuryError as e:
            ret = e.ret
        self._complete_later(op, cb, (ret,))
        return op

    def msg_send_unexpected(self, dest, data, tag, cb) -> NAOp:
        return self._send("unexpected", K_UNEXP, dest, data, tag, cb,
                          self.max_unexpected_size)

    def msg_send_expected(self, dest, data, tag, cb) -> NAOp:
        return self._send("expected", K_EXP, dest, data, tag, cb,
                          self.max_expected_size)

    def msg_recv_unexpected(self, cb) -> NAOp:
        op = self._new_op("recv_unexpected")
        self._post(lambda: self._recv_unexpected.append((op, cb)))
        return op

    def msg_recv_expected(self, source, tag, cb) -> NAOp:
        op = self._new_op("recv_expected")
        src = source.uri if source is not None else None
        self._post(lambda: self._recv_expected.append((op, src, tag, cb)))
        return op

    # -- RMA -------------------------------------------------------------------
    def alloc_array(self, shape, dtype=np.uint8) -> np.ndarray:
        """Allocate an ndarray in a shared-memory segment.  Registration of
        such arrays is visible to peers in *other* processes (memdir)."""
        dtype = np.dtype(dtype)
        nbytes = max(1, int(np.prod(shape)) * dtype.itemsize)
        seg = _create(f"mjrp-rm-{uuid.uuid4().hex[:16]}", nbytes)
        base_addr = np.frombuffer(seg.buf, np.uint8).__array_interface__["data"][0]
        with self._lock:
            self._allocs.append((seg.name, seg, base_addr, seg.size))
        return np.ndarray(shape, dtype=dtype, buffer=seg.buf)

    def alloc_msg_buffer(self, nbytes: int) -> np.ndarray:
        """Rendezvous payloads must live in shm so peers in other
        processes can pull them one-sidedly."""
        return self.alloc_array((max(1, nbytes),), np.uint8)

    def free_msg_buffer(self, arr: np.ndarray) -> None:
        backing = self._shm_backing(self.as_view(arr))
        if backing is None:
            return
        name = backing[0]
        with self._lock:
            for i, (n, seg, _base, _size) in enumerate(self._allocs):
                if n == name:
                    del self._allocs[i]
                    break
            else:
                return
        _close_seg(seg, unlink=True)

    def _shm_backing(self, view: memoryview) -> Optional[Tuple[str, int]]:
        if view.nbytes == 0:
            return None
        addr = np.frombuffer(view, np.uint8).__array_interface__["data"][0]
        with self._lock:
            for name, _seg, base, size in self._allocs:
                if base <= addr and addr + view.nbytes <= base + size:
                    return name, addr - base
        return None

    def mem_register(self, buf, read=True, write=True, key=None) -> NAMemHandle:
        view = self.as_view(buf)
        key = key if key is not None else self._mem_counter.next()
        backing = self._shm_backing(view)
        ent = None
        if backing is not None:
            seg_name, seg_off = backing
            mv = self._ctl.buf
            with self._lock:
                for i in range(MEMDIR_ENTRIES):
                    off = _MEMDIR_OFF + i * ENT_SZ
                    if mv[off] == 0:
                        flags = (1 if read else 0) | (2 if write else 0)
                        name_b = seg_name.encode()
                        _ENT.pack_into(mv, off, 0, key, seg_off, view.nbytes,
                                       flags, len(name_b))
                        mv[off + _ENT.size:off + _ENT.size + len(name_b)] = name_b
                        mv[off] = 1    # publish last
                        ent = i
                        break
                else:
                    # failing loudly beats a misleading cross-process
                    # PERMISSION error at the (remote) point of use
                    raise MercuryError(
                        Ret.NOMEM, "sm memdir full: too many concurrently "
                                   "registered shm-backed buffers")
        with self._lock:
            self._mem[key] = (view, read, write, ent)
        return NAMemHandle(key=key, size=view.nbytes, owner_uri=self._uri,
                           read_allowed=read, write_allowed=write,
                           local_buf=view)

    def mem_deregister(self, mh: NAMemHandle) -> None:
        with self._lock:
            entry = self._mem.pop(mh.key, None)
            if entry is not None and entry[3] is not None:
                self._ctl.buf[_MEMDIR_OFF + entry[3] * ENT_SZ] = 0

    def _remote_view(self, dest: NAAddress, remote: NAMemHandle,
                     want_write: bool):
        """Resolve the destination buffer for a one-sided op — without any
        involvement of the target's progress loop.  Returns ``(view, seg)``;
        ``seg`` is a per-op attachment the caller must release after the
        copy (None for in-process peers).  Attachments are deliberately not
        cached: rendezvous payload segments are one-shot, and caching them
        would pin every unlinked payload mapping until finalize."""
        with _PROCESS_LOCK:
            peer = _PROCESS.get(dest.uri)
        if peer is not None and not peer._finalized:
            with peer._lock:
                entry = peer._mem.get(remote.key)
            if entry is None:
                raise MercuryError(Ret.PERMISSION,
                                   f"mem key {remote.key} not registered at {dest.uri}")
            view, read, write, _ = entry
            if want_write and not write:
                raise MercuryError(Ret.PERMISSION, "remote handle is read-only")
            if not want_write and not read:
                raise MercuryError(Ret.PERMISSION, "remote handle is write-only")
            return view, None
        # cross-process: consult the owner's memdir
        ctl = self._peer_ctl(dest.uri)
        for i in range(MEMDIR_ENTRIES):
            off = _MEMDIR_OFF + i * ENT_SZ
            state, key, seg_off, size, flags, nlen = _ENT.unpack_from(ctl, off)
            if state != 1 or key != remote.key:
                continue
            if want_write and not flags & 2:
                raise MercuryError(Ret.PERMISSION, "remote handle is read-only")
            if not want_write and not flags & 1:
                raise MercuryError(Ret.PERMISSION, "remote handle is write-only")
            name = bytes(ctl[off + _ENT.size:off + _ENT.size + nlen]).decode()
            try:
                seg = _attach(name)
            except FileNotFoundError:
                raise MercuryError(Ret.DISCONNECT,
                                   f"sm RMA segment {name} vanished")
            return seg.buf[seg_off:seg_off + size], seg
        raise MercuryError(
            Ret.PERMISSION,
            f"mem key {remote.key} not in {dest.uri} memdir (cross-process "
            f"sm RMA needs shm-backed buffers; see SMPlugin.alloc_array)")

    def _rma(self, kind: str, local, local_off, dest, remote, remote_off,
             size, cb, want_write: bool) -> NAOp:
        op = self._new_op(kind)
        rview, seg = self._remote_view(dest, remote, want_write=want_write)
        try:
            if remote_off + size > rview.nbytes or \
                    local_off + size > local.local_buf.nbytes:
                raise MercuryError(Ret.INVALID_ARG, f"RMA {kind} out of bounds")
            if want_write:
                rview[remote_off:remote_off + size] = \
                    local.local_buf[local_off:local_off + size]
            else:
                local.local_buf[local_off:local_off + size] = \
                    rview[remote_off:remote_off + size]
        finally:
            if seg is not None:
                rview.release()
                _close_seg(seg)
        self._complete_later(op, cb, (Ret.SUCCESS,))
        return op

    def put(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        return self._rma("put", local, local_off, dest, remote, remote_off,
                         size, cb, want_write=True)

    def get(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        return self._rma("get", local, local_off, dest, remote, remote_off,
                         size, cb, want_write=False)

    def _complete_later(self, op: NAOp, cb: NACallback, args: Tuple) -> None:
        self._post(lambda: self._completions.append((op, cb, args)))

    # -- progress --------------------------------------------------------------
    def _match_queues(self) -> None:
        while self._in_unexpected and self._recv_unexpected:
            op, cb = self._recv_unexpected.popleft()
            if op.canceled:
                continue
            src, tag, data = self._in_unexpected.popleft()
            op.done = True
            self._completions.append((op, cb, (Ret.SUCCESS, SMAddress(src),
                                               tag, data)))
        if self._in_expected:
            remaining = deque()
            while self._in_expected:
                src, tag, data = self._in_expected.popleft()
                hit = None
                for i, (op, want_src, want_tag, cb) in enumerate(self._recv_expected):
                    if op.canceled:
                        continue
                    if want_tag == tag and (want_src is None or want_src == src):
                        hit = i
                        break
                if hit is None:
                    remaining.append((src, tag, data))
                else:
                    op, _, _, cb = self._recv_expected.pop(hit)
                    op.done = True
                    self._completions.append((op, cb, (Ret.SUCCESS, data)))
            self._in_expected = remaining
        self._recv_expected = [r for r in self._recv_expected
                               if not r[0].canceled]

    def _drain_conn(self, conn: _SMConn) -> None:
        consumed = False
        while True:
            frame = conn.rx.try_read()
            if frame is None:
                break
            consumed = True
            kind, tag, payload = frame
            if kind == K_UNEXP:
                self._in_unexpected.append((conn.peer_uri, tag,
                                            memoryview(payload)))
            elif kind == K_EXP:
                self._in_expected.append((conn.peer_uri, tag,
                                          memoryview(payload)))
        if consumed and conn.rx.waiting:
            conn.rx.waiting = False
            self._ring_bell(conn.bell_fd)   # peer has backlog; space freed
        with self._tx_lock:
            self._flush_backlog_locked(conn)

    def _run_pending(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    return
                fn = self._pending.popleft()
            fn()

    def progress(self, timeout: float) -> bool:
        if self._finalized:
            return False
        self._run_pending()
        if self._completions or self._pending:
            timeout = 0
        events = self._sel.select(timeout if timeout > 0 else 0)
        for key, _mask in events:
            try:
                if key.data == "bell":
                    self._scan_slots = True
                    while os.read(self._bell_r, 4096):
                        pass
                else:
                    while self._wake_r.recv(4096):
                        pass
                    self._wake_pending = False
            except (BlockingIOError, InterruptedError, OSError):
                if key.data != "bell":
                    self._wake_pending = False
        self._run_pending()
        if self._scan_slots:
            self._scan_slots = False
            self._accept_new()
        with self._tx_lock:
            conns = list(self._conns.values())
        for conn in conns:
            if not conn.closed:
                self._drain_conn(conn)
        self._match_queues()

        fired = False
        while self._completions:
            op, cb, args = self._completions.popleft()
            if op.canceled:
                continue
            op.done = True
            fired = True
            cb(*args)
        return fired

    def finalize(self) -> None:
        if self._finalized:
            return
        self._finalized = True
        with _PROCESS_LOCK:
            _PROCESS.pop(self._uri, None)
        self.interrupt()
        with self._tx_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        with self._lock:
            peer_ctls = list(self._peer_ctls.values())
            self._peer_ctls.clear()
            allocs = list(self._allocs)
            self._allocs.clear()
        for conn in conns:
            conn.closed = True
            try:
                os.close(conn.bell_fd)
            except OSError:
                pass
            conn.tx.release()
            conn.rx.release()
            _close_seg(conn.shm, unlink=conn.owner)
        for shm in peer_ctls:
            _close_seg(shm)
        for _name, seg, _base, _size in allocs:
            _close_seg(seg, unlink=True)
        try:
            self._sel.close()
        except Exception:
            pass
        for fd in (self._bell_r,):
            try:
                os.close(fd)
            except OSError:
                pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        _close_seg(self._ctl, unlink=True)
        try:
            os.unlink(self._bell_path)
        except OSError:
            pass
