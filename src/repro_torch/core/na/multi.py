"""Multi-transport NA plugin — locality-tiered address resolution.

A service that listens on several transports advertises an *address set*
(semicolon-joined URIs, cheapest tier first):

    self://svc1;sm://svc1;tcp://10.0.0.3:40125

``addr_lookup`` resolves an address set to the cheapest transport that can
actually reach the target (self > sm > tcp): ``self`` probes the
in-process registry, ``sm`` probes segment attachability (same host), and
``tcp`` always matches syntactically.  Every other operation routes by the
scheme of the (already resolved) concrete address, so upper layers —
HGClass, the bulk layer, services — stay completely transport-blind.

Memory registration registers the buffer with *every* transport under one
shared key, so a bulk descriptor minted here is valid no matter which tier
each peer resolves (see DESIGN.md §5).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..types import MercuryError, Ret
from .base import (NAAddress, NACallback, NACap, NAMemHandle, NAOp, NAPlugin,
                   SCHEME_TIERS)


def parse_addr_set(uri: str) -> List[str]:
    return [u for u in (p.strip() for p in uri.split(";")) if u]


def scheme_of(uri: str) -> str:
    return uri.split("://", 1)[0] if "://" in uri else uri


class MultiAddress(NAAddress):
    def __init__(self, uri: str):
        self.uri = uri


class MultiPlugin(NAPlugin):
    name = "multi"

    def __init__(self, plugins: Sequence[NAPlugin]):
        super().__init__()
        if not plugins:
            raise MercuryError(Ret.INVALID_ARG, "multi needs >= 1 plugin")
        self._plugins = sorted(plugins, key=lambda p: p.tier)
        self._by_scheme: Dict[str, NAPlugin] = {}
        for p in self._plugins:
            if p.name in self._by_scheme:
                raise MercuryError(Ret.INVALID_ARG,
                                   f"duplicate transport: {p.name}")
            self._by_scheme[p.name] = p
        self._by_scheme.setdefault("tcp-anon", self._by_scheme.get("tcp"))
        # conservative limits: a message must fit whichever tier resolves
        self.max_unexpected_size = min(p.max_unexpected_size
                                       for p in self._plugins)
        self.max_expected_size = min(p.max_expected_size
                                     for p in self._plugins)
        # unexpected-recv pump: one persistent pre-posted recv per transport
        # feeds a queue of logical recv ops (posting one recv per transport
        # per logical op would grow unboundedly under HGClass's repost loop)
        self._uq_lock = threading.Lock()
        self._uq: Deque[Tuple[NAOp, NACallback]] = deque()  #: guarded-by _uq_lock
        self._ustash: Deque[Tuple] = deque()  #: guarded-by _uq_lock
        self._pumps_armed = False  #: guarded-by _uq_lock

    def _route(self, addr: NAAddress) -> NAPlugin:
        p = self._by_scheme.get(scheme_of(addr.uri))
        if p is None:
            raise MercuryError(Ret.INVALID_ARG,
                               f"no transport for {addr.uri}")
        return p

    def caps_for(self, addr: NAAddress) -> NACap:
        return self._route(addr).caps

    def alloc_msg_buffer(self, nbytes: int):
        for p in self._plugins:
            buf = p.alloc_msg_buffer(nbytes)
            if buf is not None:
                return buf
        return None

    def free_msg_buffer(self, arr) -> None:
        for p in self._plugins:
            p.free_msg_buffer(arr)

    # -- addressing ----------------------------------------------------------
    def addr_self(self) -> NAAddress:
        return MultiAddress(";".join(p.addr_self().uri
                                     for p in self._plugins))

    def local_uris(self) -> List[str]:
        return [u for p in self._plugins for u in p.local_uris()]

    def addr_lookup(self, uri: str) -> NAAddress:
        cands = sorted(parse_addr_set(uri),
                       key=lambda u: SCHEME_TIERS.get(scheme_of(u), 99))
        last: Optional[MercuryError] = None
        for cand in cands:
            p = self._by_scheme.get(scheme_of(cand))
            if p is None:
                continue
            try:
                return p.addr_lookup(cand)
            except MercuryError as e:
                last = e
        raise last or MercuryError(Ret.NOENTRY,
                                   f"no reachable transport in {uri!r}")

    # -- two-sided messaging -------------------------------------------------
    def msg_send_unexpected(self, dest, data, tag, cb) -> NAOp:
        return self._route(dest).msg_send_unexpected(dest, data, tag, cb)

    def msg_send_expected(self, dest, data, tag, cb) -> NAOp:
        return self._route(dest).msg_send_expected(dest, data, tag, cb)

    def _arm_pump(self, p: NAPlugin) -> None:
        p.msg_recv_unexpected(
            lambda ret, src, tag, data, _p=p: self._on_unexp(_p, ret, src,
                                                             tag, data))

    def _on_unexp(self, p: NAPlugin, ret, src, tag, data) -> None:
        self._arm_pump(p)                  # keep the pipeline full
        with self._uq_lock:
            while self._uq:
                op, cb = self._uq.popleft()
                if op.canceled:
                    continue
                op.done = True
                break
            else:
                self._ustash.append((ret, src, tag, data))
                return
        cb(ret, src, tag, data)

    def _drain_stash(self) -> bool:
        fired = False
        while True:
            with self._uq_lock:
                if not self._ustash or not self._uq:
                    return fired
                msg = self._ustash.popleft()
                op, cb = self._uq.popleft()
                if op.canceled:
                    self._ustash.appendleft(msg)
                    continue
                op.done = True
            cb(*msg)
            fired = True

    def msg_recv_unexpected(self, cb) -> NAOp:
        op = self._new_op("recv_unexpected")
        with self._uq_lock:
            self._uq.append((op, cb))
            if not self._pumps_armed:
                self._pumps_armed = True
                for p in self._plugins:
                    self._arm_pump(p)
        self.interrupt()
        return op

    def msg_recv_expected(self, source, tag, cb) -> NAOp:
        if source is None:
            raise MercuryError(Ret.INVALID_ARG,
                               "multi-transport expected recv needs a source")
        return self._route(source).msg_recv_expected(source, tag, cb)

    # -- RMA -----------------------------------------------------------------
    def mem_register(self, buf, read=True, write=True, key=None) -> NAMemHandle:
        key = key if key is not None else self._mem_counter.next()
        sub: Dict[str, NAMemHandle] = {}
        try:
            for p in self._plugins:
                sub[p.name] = p.mem_register(buf, read=read, write=write,
                                             key=key)
        except MercuryError:
            for name, mh in sub.items():   # roll back partial registration
                self._by_scheme[name].mem_deregister(mh)
            raise
        first = sub[self._plugins[0].name]
        return NAMemHandle(key=key, size=first.size,
                           owner_uri=self.addr_self().uri,
                           read_allowed=read, write_allowed=write,
                           local_buf=first.local_buf, sub=sub)

    def mem_deregister(self, mh: NAMemHandle) -> None:
        for p in self._plugins:
            p.mem_deregister(mh)

    @staticmethod
    def _local_for(local: NAMemHandle, p: NAPlugin) -> NAMemHandle:
        return local.sub[p.name] if local.sub else local

    def put(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        p = self._route(dest)
        return p.put(self._local_for(local, p), local_off, dest, remote,
                     remote_off, size, cb)

    def get(self, local, local_off, dest, remote, remote_off, size, cb) -> NAOp:
        p = self._route(dest)
        return p.get(self._local_for(local, p), local_off, dest, remote,
                     remote_off, size, cb)

    # -- progress ------------------------------------------------------------
    def progress(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        fired = self._drain_stash()
        for p in self._plugins:
            fired |= p.progress(0.0)
        fired |= self._drain_stash()
        if fired or timeout <= 0:
            return fired
        while True:
            for p in self._plugins:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                if p.progress(min(0.005, rem)) | self._drain_stash():
                    return True

    def interrupt(self) -> None:
        for p in self._plugins:
            p.interrupt()

    def finalize(self) -> None:
        for p in self._plugins:
            p.finalize()
