"""``tcp`` NA plugin — non-blocking sockets, real multi-process transport.

This is the DCN-side transport for host services on a TPU cluster. RMA is
emulated with request/response frames (exactly how Mercury's tcp providers
implement NA put/get when the fabric has no one-sided verbs): the API stays
one-sided — the *target of the transfer* never posts anything; its progress
loop serves registered memory.

Threading model: any thread may post operations; a single thread (usually
the Engine's progress thread) calls :meth:`progress`, which owns the
selector. Cross-thread posts are handed over via a queue + wakeup pipe.
"""
from __future__ import annotations

import errno
import selectors
import socket
import struct
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..types import MercuryError, Ret, _Counter
from .base import (NAAddress, NACallback, NACap, NAMemHandle, NAOp, NAPlugin,
                   TIER_NET, UNEXPECTED_MSG_LIMIT)

_U32 = struct.Struct("<I")
_FRAME_HDR = struct.Struct("<IB")  # total payload len (incl kind byte? no: after), kind

K_HELLO = 0
K_UNEXP = 1
K_EXP = 2
K_GET_REQ = 3
K_GET_RSP = 4
K_PUT = 5
K_PUT_ACK = 6

_TAG = struct.Struct("<Q")
_GET_REQ = struct.Struct("<QQQQ")      # token, key, off, len
_RMA_RSP = struct.Struct("<QB")        # token, ret
_PUT_HDR = struct.Struct("<QQQ")       # token, key, off

MAX_FRAME = 64 * 1024 * 1024


class TCPAddress(NAAddress):
    def __init__(self, uri: str):
        self.uri = uri


def _parse_uri(uri: str) -> Tuple[str, int]:
    if not uri.startswith("tcp://"):
        raise MercuryError(Ret.INVALID_ARG, f"not a tcp uri: {uri}")
    hostport = uri[len("tcp://"):]
    host, _, port = hostport.rpartition(":")
    return host, int(port)


class _Conn:
    __slots__ = ("sock", "peer_uri", "inbuf", "outbuf", "registered",
                 "closed", "said_hello")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.peer_uri: Optional[str] = None
        self.inbuf = bytearray()
        self.outbuf: Deque[memoryview] = deque()
        self.registered = False
        self.closed = False
        self.said_hello = False

    def queue(self, *chunks: bytes) -> None:
        for c in chunks:
            if c:
                self.outbuf.append(memoryview(c))


class TCPPlugin(NAPlugin):
    name = "tcp"
    caps = NACap.NONE                    # RMA is frame-emulated
    tier = TIER_NET
    max_unexpected_size = UNEXPECTED_MSG_LIMIT
    max_expected_size = MAX_FRAME - 4096  # response framing headroom

    def __init__(self, uri: Optional[str] = None, listen: bool = True):
        super().__init__()
        self._sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._pending: Deque = deque()        # cross-thread posted ops
        self._conns: Dict[str, _Conn] = {}    # peer_uri -> conn
        self._listener: Optional[socket.socket] = None
        self._anon_counter = _Counter()

        # wakeup pipe
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, ("wake", None))

        if listen:
            host, port = ("127.0.0.1", 0)
            if uri:
                host, port = _parse_uri(uri)
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            ls.bind((host, port))
            ls.listen(128)
            ls.setblocking(False)
            self._listener = ls
            self._uri = f"tcp://{ls.getsockname()[0]}:{ls.getsockname()[1]}"
            self._sel.register(ls, selectors.EVENT_READ, ("accept", None))
        else:
            self._uri = f"tcp-anon://{id(self):x}"

        # posted receives / queues (owned by progress thread)
        self._recv_unexpected: Deque[Tuple[NAOp, NACallback]] = deque()
        self._in_unexpected: Deque[Tuple[str, int, memoryview]] = deque()
        self._recv_expected: List[Tuple[NAOp, Optional[str], int, NACallback]] = []
        self._in_expected: Deque[Tuple[str, int, memoryview]] = deque()
        self._mem: Dict[int, Tuple[memoryview, bool, bool]] = {}  #: guarded-by _lock
        self._rma_pending: Dict[int, Tuple[NAOp, NACallback, NAMemHandle, int]] = {}
        self._rma_token = _Counter()
        self._completions: Deque[Tuple[NAOp, NACallback, Tuple]] = deque()
        self._finalized = False

    # -- addressing ----------------------------------------------------------
    def addr_self(self) -> NAAddress:
        return TCPAddress(self._uri)

    def addr_lookup(self, uri: str) -> NAAddress:
        if not (uri.startswith("tcp://") or uri.startswith("tcp-anon://")):
            raise MercuryError(Ret.INVALID_ARG, f"not a tcp uri: {uri}")
        return TCPAddress(uri)

    # -- cross-thread posting -------------------------------------------------
    def _post(self, fn) -> None:
        with self._lock:
            self._pending.append(fn)
        self.interrupt()

    def interrupt(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    # -- connection management (progress thread only) -------------------------
    def _connect(self, uri: str) -> _Conn:
        conn = self._conns.get(uri)
        if conn and not conn.closed:
            return conn
        if uri.startswith("tcp-anon://"):
            raise MercuryError(Ret.DISCONNECT, f"anonymous peer {uri} not connected")
        host, port = _parse_uri(uri)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setblocking(False)
        try:
            s.connect((host, port))
        except BlockingIOError:
            pass
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(s)
        conn.peer_uri = uri
        self._conns[uri] = conn
        self._sel.register(s, selectors.EVENT_READ | selectors.EVENT_WRITE,
                           ("conn", conn))
        conn.registered = True
        # first frame: HELLO with our uri so the peer can address us
        self._send_frame(conn, K_HELLO, self._uri.encode())
        return conn

    def _send_frame(self, conn: _Conn, kind: int, *parts: bytes) -> None:
        total = sum(len(p) for p in parts)
        if total + 1 > MAX_FRAME:
            raise MercuryError(Ret.INVALID_ARG, f"frame too large: {total}")
        conn.queue(_FRAME_HDR.pack(total + 1, kind), *parts)
        self._want_write(conn)

    def _want_write(self, conn: _Conn) -> None:
        if conn.registered and not conn.closed:
            self._sel.modify(conn.sock, selectors.EVENT_READ | selectors.EVENT_WRITE,
                             ("conn", conn))

    def _close_conn(self, conn: _Conn, ret: Ret = Ret.DISCONNECT) -> None:
        if conn.closed:
            return
        conn.closed = True
        try:
            if conn.registered:
                self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        if conn.peer_uri and self._conns.get(conn.peer_uri) is conn:
            del self._conns[conn.peer_uri]
        # fail pending RMA ops routed to this peer
        dead = [t for t, (_op, _cb, _mh, _sz) in self._rma_pending.items()]
        for t in dead:
            op, cb, _mh, _sz = self._rma_pending[t]
            if op.user == conn.peer_uri:
                del self._rma_pending[t]
                self._completions.append((op, cb, (ret,)))
        # fail expected receives bound to this source
        still = []
        for op, src, tag, cb in self._recv_expected:
            if src is not None and src == conn.peer_uri:
                self._completions.append((op, cb, (ret, memoryview(b""))))
            else:
                still.append((op, src, tag, cb))
        self._recv_expected = still

    # -- messaging API ---------------------------------------------------------
    def msg_send_unexpected(self, dest, data, tag, cb) -> NAOp:
        self._check_msg_size(data, self.max_unexpected_size, "unexpected")
        op = self._new_op("send_unexpected")
        if not isinstance(data, tuple):
            data = bytes(data)

        def do():
            try:
                conn = self._connect(dest.uri)
                parts = data if isinstance(data, tuple) else (data,)
                self._send_frame(conn, K_UNEXP, _TAG.pack(tag), *parts)
                self._completions.append((op, cb, (Ret.SUCCESS,)))
            except MercuryError as e:
                self._completions.append((op, cb, (e.ret,)))

        self._post(do)
        return op

    def msg_recv_unexpected(self, cb) -> NAOp:
        op = self._new_op("recv_unexpected")
        self._post(lambda: self._recv_unexpected.append((op, cb)))
        return op

    def msg_send_expected(self, dest, data, tag, cb) -> NAOp:
        self._check_msg_size(data, self.max_expected_size, "expected")
        op = self._new_op("send_expected")
        if not isinstance(data, tuple):
            data = bytes(data)

        def do():
            try:
                conn = self._connect(dest.uri)
                parts = data if isinstance(data, tuple) else (data,)
                self._send_frame(conn, K_EXP, _TAG.pack(tag), *parts)
                self._completions.append((op, cb, (Ret.SUCCESS,)))
            except MercuryError as e:
                self._completions.append((op, cb, (e.ret,)))

        self._post(do)
        return op

    def msg_recv_expected(self, source, tag, cb) -> NAOp:
        op = self._new_op("recv_expected")
        src = source.uri if source is not None else None
        self._post(lambda: self._recv_expected.append((op, src, tag, cb)))
        return op

    # -- RMA ---------------------------------------------------------------------
    def mem_register(self, buf, read=True, write=True, key=None) -> NAMemHandle:
        view = self.as_view(buf)
        key = key if key is not None else self._mem_counter.next()
        with self._lock:
            self._mem[key] = (view, read, write)
        return NAMemHandle(key=key, size=view.nbytes, owner_uri=self._uri,
                           read_allowed=read, write_allowed=write, local_buf=view)

    def mem_deregister(self, mh: NAMemHandle) -> None:
        with self._lock:
            self._mem.pop(mh.key, None)

    def get(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        op = self._new_op("get")
        op.user = dest.uri

        def do():
            try:
                conn = self._connect(dest.uri)
                token = self._rma_token.next()
                self._rma_pending[token] = (op, cb, local, local_off)
                self._send_frame(conn, K_GET_REQ,
                                 _GET_REQ.pack(token, remote.key, remote_off, size))
            except MercuryError as e:
                self._completions.append((op, cb, (e.ret,)))

        self._post(do)
        return op

    def put(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        op = self._new_op("put")
        op.user = dest.uri
        payload = bytes(local.local_buf[local_off:local_off + size])

        def do():
            try:
                conn = self._connect(dest.uri)
                token = self._rma_token.next()
                self._rma_pending[token] = (op, cb, local, local_off)
                self._send_frame(conn, K_PUT,
                                 _PUT_HDR.pack(token, remote.key, remote_off), payload)
            except MercuryError as e:
                self._completions.append((op, cb, (e.ret,)))

        self._post(do)
        return op

    # -- frame handling (progress thread) -----------------------------------------
    def _on_frame(self, conn: _Conn, kind: int, payload: memoryview) -> None:
        if kind == K_HELLO:
            uri = bytes(payload).decode()
            conn.peer_uri = uri
            self._conns[uri] = conn
            return
        src = conn.peer_uri or f"tcp-anon://{self._anon_counter.next():x}"
        if kind == K_UNEXP:
            tag = _TAG.unpack_from(payload)[0]
            self._in_unexpected.append((src, tag, payload[_TAG.size:]))
        elif kind == K_EXP:
            tag = _TAG.unpack_from(payload)[0]
            self._in_expected.append((src, tag, payload[_TAG.size:]))
        elif kind == K_GET_REQ:
            token, key, off, ln = _GET_REQ.unpack_from(payload)
            with self._lock:
                entry = self._mem.get(key)
            if entry is None or not entry[1] or off + ln > entry[0].nbytes:
                self._send_frame(conn, K_GET_RSP, _RMA_RSP.pack(token, int(Ret.PERMISSION)))
            else:
                data = entry[0][off:off + ln]     # zero-copy: registered
                self._send_frame(conn, K_GET_RSP, _RMA_RSP.pack(token, int(Ret.SUCCESS)), data)
        elif kind == K_GET_RSP:
            token, ret = _RMA_RSP.unpack_from(payload)
            pend = self._rma_pending.pop(token, None)
            if pend is None:
                return
            op, cb, local, local_off = pend
            data = payload[_RMA_RSP.size:]
            if ret == Ret.SUCCESS:
                local.local_buf[local_off:local_off + len(data)] = data
            self._completions.append((op, cb, (Ret(ret),)))
        elif kind == K_PUT:
            token, key, off = _PUT_HDR.unpack_from(payload)
            data = payload[_PUT_HDR.size:]
            with self._lock:
                entry = self._mem.get(key)
            if entry is None or not entry[2] or off + len(data) > entry[0].nbytes:
                self._send_frame(conn, K_PUT_ACK, _RMA_RSP.pack(token, int(Ret.PERMISSION)))
            else:
                entry[0][off:off + len(data)] = data
                self._send_frame(conn, K_PUT_ACK, _RMA_RSP.pack(token, int(Ret.SUCCESS)))
        elif kind == K_PUT_ACK:
            token, ret = _RMA_RSP.unpack_from(payload)
            pend = self._rma_pending.pop(token, None)
            if pend is None:
                return
            op, cb, _local, _off = pend
            self._completions.append((op, cb, (Ret(ret),)))

    def _read_conn(self, conn: _Conn) -> None:
        try:
            while True:
                chunk = conn.sock.recv(1 << 18)
                if not chunk:
                    self._close_conn(conn)
                    return
                conn.inbuf += chunk
                if len(chunk) < (1 << 18):
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close_conn(conn)
            return
        # parse complete frames
        buf = conn.inbuf
        pos = 0
        n = len(buf)
        while n - pos >= _FRAME_HDR.size:
            total, kind = _FRAME_HDR.unpack_from(buf, pos)
            if total > MAX_FRAME:
                self._close_conn(conn, Ret.PROTOCOL_ERROR)
                return
            if n - pos - _U32.size < total:
                break
            start = pos + _FRAME_HDR.size
            end = pos + _U32.size + total
            self._on_frame(conn, kind, memoryview(bytes(buf[start:end])))
            pos = end
        if pos:
            del conn.inbuf[:pos]

    def _write_conn(self, conn: _Conn) -> None:
        try:
            while conn.outbuf:
                sent = conn.sock.send(conn.outbuf[0])
                if sent < len(conn.outbuf[0]):
                    conn.outbuf[0] = conn.outbuf[0][sent:]
                    return
                conn.outbuf.popleft()
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            if e.errno == errno.EINPROGRESS:
                return
            self._close_conn(conn)
            return
        if not conn.outbuf and conn.registered and not conn.closed:
            self._sel.modify(conn.sock, selectors.EVENT_READ, ("conn", conn))

    def _match_queues(self) -> None:
        while self._in_unexpected and self._recv_unexpected:
            op, cb = self._recv_unexpected.popleft()
            if op.canceled:
                continue
            src, tag, data = self._in_unexpected.popleft()
            op.done = True
            self._completions.append((op, cb, (Ret.SUCCESS, TCPAddress(src), tag, data)))
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
        self._recv_expected = [r for r in self._recv_expected if not r[0].canceled]

    def progress(self, timeout: float) -> bool:
        if self._finalized:
            return False
        # run cross-thread posted ops
        while True:
            with self._lock:
                if not self._pending:
                    break
                fn = self._pending.popleft()
            fn()

        events = self._sel.select(timeout if timeout > 0 else 0)
        for key, mask in events:
            what, obj = key.data
            if what == "wake":
                try:
                    while self._wake_r.recv(4096):
                        pass
                except (BlockingIOError, InterruptedError):
                    pass
            elif what == "accept":
                try:
                    while True:
                        s, _ = self._listener.accept()
                        s.setblocking(False)
                        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                        conn = _Conn(s)
                        self._sel.register(s, selectors.EVENT_READ, ("conn", conn))
                        conn.registered = True
                        self._send_frame(conn, K_HELLO, self._uri.encode())
                except (BlockingIOError, InterruptedError):
                    pass
            elif what == "conn":
                if mask & selectors.EVENT_WRITE:
                    self._write_conn(obj)
                if mask & selectors.EVENT_READ and not obj.closed:
                    self._read_conn(obj)

        # re-run posts that arrived during select
        while True:
            with self._lock:
                if not self._pending:
                    break
                fn = self._pending.popleft()
            fn()

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
        self._finalized = True
        self.interrupt()
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        for sock in (self._listener, self._wake_r, self._wake_w):
            try:
                if sock:
                    sock.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except Exception:
            pass
