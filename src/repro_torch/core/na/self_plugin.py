"""``self`` NA plugin — in-process loopback transport.

Several plugin *instances* may coexist in one process, each with its own
URI (``self://name``); this lets tests and benchmarks stand up multi-node
service topologies (origin + several targets) without sockets. Message
delivery is a queue append; RMA put/get is a memcpy against the peer's
registered-memory table. Semantics (unexpected vs expected matching,
completion via callbacks inside ``progress()``) are identical to the tcp
plugin so upper layers cannot tell the difference — that interchangeability
is the point of the NA abstraction.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..types import MercuryError, Ret
from .base import (NAAddress, NACallback, NACap, NAMemHandle, NAOp, NAPlugin,
                   TIER_SELF)

_REGISTRY: Dict[str, "SelfPlugin"] = {}  #: guarded-by _REGISTRY_LOCK
_REGISTRY_LOCK = threading.Lock()
_ANON = [0]


class SelfAddress(NAAddress):
    def __init__(self, uri: str):
        self.uri = uri


class SelfPlugin(NAPlugin):
    name = "self"
    caps = NACap.NATIVE_RMA | NACap.ZERO_COPY | NACap.SAME_PROCESS
    tier = TIER_SELF
    max_expected_size = 1 << 62          # a memcpy: no framing limit

    def __init__(self, uri: Optional[str] = None):
        super().__init__()
        with _REGISTRY_LOCK:
            if uri is None:
                _ANON[0] += 1
                uri = f"self://node{_ANON[0]}"
            if not uri.startswith("self://"):
                uri = "self://" + uri
            if uri in _REGISTRY:
                raise MercuryError(Ret.INVALID_ARG, f"uri in use: {uri}")
            _REGISTRY[uri] = self
        self._uri = uri
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        # inbound queues (written by peers, drained by our progress())
        self._in_unexpected: Deque[Tuple[str, int, bytes, NAOp, "SelfPlugin"]] = deque()  #: guarded-by _lock,_wakeup
        self._in_expected: Deque[Tuple[str, int, bytes, NAOp, "SelfPlugin"]] = deque()  #: guarded-by _lock,_wakeup
        # posted receives
        self._recv_unexpected: Deque[Tuple[NAOp, NACallback]] = deque()  #: guarded-by _lock,_wakeup
        self._recv_expected: List[Tuple[NAOp, Optional[str], int, NACallback]] = []  #: guarded-by _lock,_wakeup
        # local completions to fire on next progress() (send/rma ops)
        self._completions: Deque[Tuple[NAOp, NACallback, Tuple]] = deque()  #: guarded-by _lock,_wakeup
        self._mem: Dict[int, memoryview] = {}  #: guarded-by _lock,_wakeup
        self._finalized = False

    # -- addressing ----------------------------------------------------------
    def addr_self(self) -> NAAddress:
        return SelfAddress(self._uri)

    def local_uris(self):
        return [self._uri]

    def addr_lookup(self, uri: str) -> NAAddress:
        if not uri.startswith("self://"):
            raise MercuryError(Ret.INVALID_ARG, f"not a self uri: {uri}")
        # reachability probe: the peer must live in this process (this is
        # what lets tiered resolution fall through to sm/tcp)
        with _REGISTRY_LOCK:
            inst = _REGISTRY.get(uri)
        if inst is None or inst._finalized:
            raise MercuryError(Ret.DISCONNECT, f"no in-process peer at {uri}")
        return SelfAddress(uri)

    @staticmethod
    def _resolve(addr: NAAddress) -> "SelfPlugin":
        with _REGISTRY_LOCK:
            inst = _REGISTRY.get(addr.uri)
        if inst is None or inst._finalized:
            raise MercuryError(Ret.DISCONNECT, f"no listener at {addr.uri}")
        return inst

    # -- messaging -----------------------------------------------------------
    def msg_send_unexpected(self, dest, data, tag, cb) -> NAOp:
        self._check_msg_size(data, self.max_unexpected_size, "unexpected")
        op = self._new_op("send_unexpected")
        peer = self._resolve(dest)
        with peer._lock:
            flat = b"".join(data) if isinstance(data, tuple) else bytes(data)
            peer._in_unexpected.append((self._uri, tag, flat, op, self))
            peer._wakeup.notify_all()
        self._complete_later(op, cb, (Ret.SUCCESS,))
        return op

    def msg_recv_unexpected(self, cb) -> NAOp:
        op = self._new_op("recv_unexpected")
        with self._lock:
            self._recv_unexpected.append((op, cb))
            self._wakeup.notify_all()
        return op

    def msg_send_expected(self, dest, data, tag, cb) -> NAOp:
        self._check_msg_size(data, self.max_expected_size, "expected")
        op = self._new_op("send_expected")
        peer = self._resolve(dest)
        with peer._lock:
            flat = b"".join(data) if isinstance(data, tuple) else bytes(data)
            peer._in_expected.append((self._uri, tag, flat, op, self))
            peer._wakeup.notify_all()
        self._complete_later(op, cb, (Ret.SUCCESS,))
        return op

    def msg_recv_expected(self, source, tag, cb) -> NAOp:
        op = self._new_op("recv_expected")
        src = source.uri if source is not None else None
        with self._lock:
            self._recv_expected.append((op, src, tag, cb))
            self._wakeup.notify_all()
        return op

    # -- RMA -----------------------------------------------------------------
    def mem_register(self, buf, read=True, write=True, key=None) -> NAMemHandle:
        view = self.as_view(buf)
        key = key if key is not None else self._mem_counter.next()
        with self._lock:
            self._mem[key] = view
        return NAMemHandle(key=key, size=view.nbytes, owner_uri=self._uri,
                           read_allowed=read, write_allowed=write,
                           local_buf=view)

    def mem_deregister(self, mh: NAMemHandle) -> None:
        with self._lock:
            self._mem.pop(mh.key, None)

    def _peer_mem(self, dest: NAAddress, remote: NAMemHandle) -> memoryview:
        peer = self._resolve(dest)
        with peer._lock:
            view = peer._mem.get(remote.key)
        if view is None:
            raise MercuryError(Ret.PERMISSION, f"mem key {remote.key} not registered at {dest.uri}")
        return view

    def put(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        op = self._new_op("put")
        if not remote.write_allowed:
            raise MercuryError(Ret.PERMISSION, "remote handle is read-only")
        rview = self._peer_mem(dest, remote)
        if remote_off + size > rview.nbytes or local_off + size > local.local_buf.nbytes:
            raise MercuryError(Ret.INVALID_ARG, "RMA put out of bounds")
        rview[remote_off:remote_off + size] = local.local_buf[local_off:local_off + size]
        self._complete_later(op, cb, (Ret.SUCCESS,))
        return op

    def get(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        op = self._new_op("get")
        if not remote.read_allowed:
            raise MercuryError(Ret.PERMISSION, "remote handle is write-only")
        rview = self._peer_mem(dest, remote)
        if remote_off + size > rview.nbytes or local_off + size > local.local_buf.nbytes:
            raise MercuryError(Ret.INVALID_ARG, "RMA get out of bounds")
        local.local_buf[local_off:local_off + size] = rview[remote_off:remote_off + size]
        self._complete_later(op, cb, (Ret.SUCCESS,))
        return op

    # -- progress ------------------------------------------------------------
    def _complete_later(self, op: NAOp, cb: NACallback, args: Tuple) -> None:
        with self._lock:
            self._completions.append((op, cb, args))
            self._wakeup.notify_all()

    def _match_expected_locked(self):
        """Match queued expected messages against posted receives."""
        fired = []
        if not self._in_expected:
            return fired
        remaining = deque()
        while self._in_expected:
            src, tag, data, send_op, sender = self._in_expected.popleft()
            hit = None
            for i, (op, want_src, want_tag, cb) in enumerate(self._recv_expected):
                if op.canceled:
                    continue
                if want_tag == tag and (want_src is None or want_src == src):
                    hit = i
                    break
            if hit is None:
                remaining.append((src, tag, data, send_op, sender))
            else:
                op, _, _, cb = self._recv_expected.pop(hit)
                op.done = True
                fired.append((cb, (Ret.SUCCESS, memoryview(data))))
        self._in_expected = remaining
        return fired

    def progress(self, timeout: float) -> bool:
        fired = []
        with self._lock:
            # purge canceled posted receives
            self._recv_expected = [r for r in self._recv_expected if not r[0].canceled]
            while self._recv_unexpected and self._recv_unexpected[0][0].canceled:
                self._recv_unexpected.popleft()

            def harvest_locked():
                out = []
                while self._completions:
                    op, cb, args = self._completions.popleft()
                    if not op.canceled:
                        op.done = True
                        out.append((cb, args))
                while self._in_unexpected and self._recv_unexpected:
                    op, cb = self._recv_unexpected.popleft()
                    if op.canceled:
                        continue
                    src, tag, data, send_op, sender = self._in_unexpected.popleft()
                    op.done = True
                    out.append((cb, (Ret.SUCCESS, SelfAddress(src), tag, memoryview(data))))
                out.extend(self._match_expected_locked())
                return out

            fired = harvest_locked()
            if not fired and timeout > 0:
                self._wakeup.wait(timeout)
                fired = harvest_locked()

        for cb, args in fired:
            cb(*args)
        return bool(fired)

    def interrupt(self) -> None:
        with self._lock:
            self._wakeup.notify_all()

    def finalize(self) -> None:
        self._finalized = True
        with _REGISTRY_LOCK:
            _REGISTRY.pop(self._uri, None)
        self.interrupt()
