"""RPC core (paper contribution C2) — Mercury hg_core equivalent.

An RPC operation is deliberately *lightweight*: a buffer transmitted to a
target where a registered function callback is executed. Dispatch is by a
stable 64-bit id derived from the RPC name (both sides register the same
name). Origin and target are symmetric (C4): every :class:`HGClass` can
both forward and serve.

Flow (matches Mercury):
  origin:  handle = hg.create(addr, id)
           handle.forward(input, cb)      # encode → unexpected msg
                                          # + pre-posted expected recv(cookie)
  target:  unexpected msg → decode header → look up id
           → RPC_HANDLER completion entry on the context queue
           trigger() → handler(handle); handler: handle.get_input(),
           work (may issue bulk transfers), handle.respond(output)
  origin:  expected msg(cookie) → FORWARD completion entry → cb(info)
"""
from __future__ import annotations

import copy as _copy
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np

from . import proc as hg_proc
from .bulk import BulkDescriptor, BulkHandle, BulkOpType, bulk_transfer
from .na.base import NAAddress, NAPlugin, UNEXPECTED_MSG_LIMIT
from .progress import Context
from .types import (Callback, CallbackInfo, Flags, MercuryError, OpType,
                    PROTOCOL_VERSION, REQUEST_HEADER_SIZE,
                    RESPONSE_HEADER_SIZE, RequestHeader, ResponseHeader, Ret,
                    ZERO_TRACE_ID, _Counter, payload_crc32, stable_rpc_id)
from ..telemetry import trace as _trace


# Serialization-free self-tier dispatch (DESIGN.md §9): every listening
# HGClass registers here under each of its SAME_PROCESS (self-tier) URIs.
# An origin forwarding to one of these URIs hands the request/response
# *values* across directly — no proc encode/decode, no header round trip —
# while keeping identical Ret/cancel/deadline semantics.
_LOCAL_DISPATCH: Dict[str, "HGClass"] = {}  #: guarded-by _LOCAL_LOCK
_LOCAL_LOCK = threading.Lock()


def _local_target(uri: str) -> Optional["HGClass"]:
    if not uri.startswith("self://"):
        return None
    with _LOCAL_LOCK:
        hg = _LOCAL_DISPATCH.get(uri)
    return hg if hg is not None and hg._listening else None


@dataclass
class RPCInfo:
    name: str
    rpc_id: int
    in_proc: hg_proc.Proc
    out_proc: hg_proc.Proc
    handler: Optional[Callable[["Handle"], None]]
    no_response: bool = False


class HandleInfo:
    """hg_info: addressing info attached to a handle."""

    __slots__ = ("addr", "rpc_id", "context")

    def __init__(self, addr: NAAddress, rpc_id: int, context: Context):
        self.addr = addr
        self.rpc_id = rpc_id
        self.context = context


class Handle:
    """An RPC handle — origin side (created via HGClass.create) or target
    side (materialized by the dispatcher for an incoming request)."""

    def __init__(self, hg: "HGClass", info: HandleInfo, rpc: RPCInfo):
        self.hg = hg
        self.info = info
        self.rpc = rpc
        self.cookie: int = 0
        self.ret: Ret = Ret.SUCCESS
        self.output: Any = None          # origin: decoded response
        self._input_raw: Optional[memoryview] = None
        self._input: Any = None
        self._input_decoded = False
        self._payload_bulk: Optional[BulkHandle] = None
        self._payload_staged = None     # shm staging buffer (sm rendezvous)
        self._deadline_entry: Optional[dict] = None
        self._recv_op = None
        self._complete: Optional[Callable[..., None]] = None
        self._completed = False  #: guarded-by _lock
        # target side, self-tier fast path: set by the origin's
        # _forward_local so respond() hands the output value straight back
        # (no encode / expected-message send)
        self._local_deliver: Optional[Callable[..., None]] = None
        self._lock = threading.Lock()
        self.responded = False
        # target side: a pass_handle handler sets this before returning to
        # take ownership of responding later (event-driven response)
        self.deferred = False
        # target side: caller's remaining deadline budget (header field) and
        # local arrival time — admission control reads these via
        # remaining_budget()
        self.budget_ms: int = 0
        self.arrived: float = 0.0
        # target side: wire-propagated trace context (v5 header) and the
        # peer's protocol version (echoed in the response header so v4
        # peers keep decoding us)
        self.trace_ctx: Optional[_trace.TraceContext] = None
        self.peer_version: int = PROTOCOL_VERSION

    def _release_payload(self) -> None:
        if self._payload_bulk is not None:
            self._payload_bulk.free()
            self._payload_bulk = None
        if self._payload_staged is not None:
            self.hg.na.free_msg_buffer(self._payload_staged)
            self._payload_staged = None

    # ------------------------------------------------------------------ origin
    def forward(self, input_value: Any, cb: Optional[Callback] = None,
                timeout: Optional[float] = None, arg: Any = None) -> None:
        """Issue the RPC (non-blocking). ``cb`` fires from trigger() when the
        response (or failure/timeout) is known.

        ``timeout`` doubles as the caller's *deadline budget*: it rides the
        request header (``budget_ms``) so the target can make admission
        decisions against the time the caller is actually willing to wait."""
        hg = self.hg
        if hg.local_dispatch:
            thg = _local_target(self.info.addr.uri)
            if thg is not None and thg.local_dispatch:
                self._forward_local(thg, input_value, cb, timeout, arg)
                return
        ctx = self.info.context
        self.cookie = hg._cookie_counter.next()
        payload = hg_proc.encode(self.rpc.in_proc, input_value)
        budget_ms = 0
        if timeout is not None and timeout > 0:
            # round sub-millisecond budgets UP to 1: 0 means "no
            # deadline" on the wire, and a nearly-expired caller is the
            # one admission control most needs to know about
            budget_ms = min(max(int(timeout * 1e3), 1), 0xFFFFFFFF)
        flags = Flags.NONE
        crc = 0
        if hg.checksum_payloads:
            flags |= Flags.CHECKSUM
            crc = payload_crc32(payload)
        if self.rpc.no_response:
            flags |= Flags.NO_RESPONSE
        # ambient trace context rides the v5 header (one TLS read when
        # untraced — the near-zero unsampled path)
        tctx = _trace.current()
        if tctx is not None:
            t_id, s_id, t_fl = tctx.trace_id, tctx.span_id, tctx.flags
        else:
            t_id, s_id, t_fl = ZERO_TRACE_ID, 0, 0
        limit = getattr(hg.na, "max_unexpected_size", UNEXPECTED_MSG_LIMIT)
        if REQUEST_HEADER_SIZE + len(payload) > limit:
            # Rendezvous: the unexpected message carries only a bulk
            # descriptor; the target pulls the payload one-sidedly (a
            # single zero-copy on plugins with native RMA).
            if self.rpc.no_response:
                raise MercuryError(
                    Ret.MSGSIZE,
                    f"NO_RESPONSE rpc payload {len(payload)}B exceeds the "
                    f"eager limit {limit}B; origin cannot learn when the "
                    f"pull finished")
            flags |= Flags.RENDEZVOUS
            # transports whose RMA needs special memory (sm: cross-process
            # pulls only reach shm-backed registrations) stage the payload
            staged = hg.na.alloc_msg_buffer(len(payload))
            if staged is not None:
                staged[:len(payload)] = np.frombuffer(payload, np.uint8)
                self._payload_staged = staged
                reg_buf = staged[:len(payload)]
            else:
                reg_buf = np.frombuffer(payload, np.uint8)
            self._payload_bulk = BulkHandle(hg.na, [reg_buf],
                                            read=True, write=False)
            hdr = RequestHeader(self.rpc.rpc_id, self.cookie, flags,
                                len(payload), crc, budget_ms,
                                t_id, s_id, t_fl)
            msg = (hdr.pack(), self._payload_bulk.descriptor().to_bytes())
        else:
            hdr = RequestHeader(self.rpc.rpc_id, self.cookie, flags,
                                len(payload), crc, budget_ms,
                                t_id, s_id, t_fl)
            msg = (hdr.pack(), payload)   # vectored: no payload copy

        def complete(ret: Ret, output: Any = None):
            with self._lock:
                if self._completed:
                    return
                self._completed = True
            self._release_payload()
            self.ret = ret
            self.output = output
            if self._deadline_entry is not None:
                ctx.disarm(self._deadline_entry)
            ctx.completion_add(cb, CallbackInfo(OpType.FORWARD, ret,
                                                handle=self, arg=arg))

        self._complete = complete

        if not self.rpc.no_response:
            def on_response(ret: Ret, data: memoryview):
                if ret != Ret.SUCCESS:
                    complete(ret)
                    return
                try:
                    rhdr = ResponseHeader.unpack(data)
                    body = data[RESPONSE_HEADER_SIZE:]
                    if rhdr.payload_len and Flags.CHECKSUM and hg.checksum_payloads:
                        if rhdr.payload_crc and payload_crc32(body) != rhdr.payload_crc:
                            complete(Ret.CHECKSUM_ERROR)
                            return
                    if rhdr.ret != Ret.SUCCESS:
                        out = None
                        if rhdr.payload_len:
                            out = hg_proc.decode(hg_proc.proc_str, body)
                        complete(rhdr.ret, out)
                        return
                    out = hg_proc.decode(self.rpc.out_proc, body) \
                        if rhdr.payload_len else None
                    complete(Ret.SUCCESS, out)
                except MercuryError as e:
                    complete(e.ret)
                except Exception:
                    complete(Ret.PROTOCOL_ERROR)

            self._recv_op = hg.na.msg_recv_expected(self.info.addr, self.cookie,
                                                    on_response)
            if timeout is not None:
                def on_timeout():
                    if self._recv_op is not None:
                        hg.na.cancel(self._recv_op)
                    complete(Ret.TIMEOUT)
                self._deadline_entry = ctx.add_deadline(
                    time.monotonic() + timeout, on_timeout)

        def on_sent(ret: Ret):
            if ret != Ret.SUCCESS:
                if self._recv_op is not None:
                    hg.na.cancel(self._recv_op)
                complete(ret)
            elif self.rpc.no_response:
                complete(Ret.SUCCESS)

        hg.na.msg_send_unexpected(self.info.addr, msg, self.cookie, on_sent)

    def _forward_local(self, thg: "HGClass", input_value: Any,
                       cb: Optional[Callback], timeout: Optional[float],
                       arg: Any) -> None:
        """Self-tier fast path (DESIGN.md §9): origin and target share this
        process, so the request/response *values* are handed across
        directly — no proc encode/decode, no header pack/unpack, no
        progress-thread round trip.  Semantics match the wire path: same
        Ret codes, exactly-once completion, and cancel()/deadline behave
        identically (a response racing a cancel wins whichever grabs the
        completion lock first).

        Value isolation: the wire path serializes, so mutations on either
        side never alias.  That guarantee is kept by deep-copying the
        values unless *both* classes opted out (``copy_local=False`` with
        checksums off)."""
        hg = self.hg
        ctx = self.info.context
        self.cookie = hg._cookie_counter.next()
        budget_ms = 0
        if timeout is not None and timeout > 0:
            budget_ms = min(max(int(timeout * 1e3), 1), 0xFFFFFFFF)
        copy = (hg.checksum_payloads or hg.copy_local
                or thg.checksum_payloads or thg.copy_local)

        def complete(ret: Ret, output: Any = None):
            with self._lock:
                if self._completed:
                    return
                self._completed = True
            self.ret = ret
            self.output = output
            if self._deadline_entry is not None:
                ctx.disarm(self._deadline_entry)
            if cb is not None:
                cb(CallbackInfo(OpType.FORWARD, ret, handle=self, arg=arg))

        self._complete = complete

        tinfo = thg.registered.get(self.rpc.rpc_id)
        if tinfo is None or tinfo.handler is None:
            complete(Ret.SUCCESS if self.rpc.no_response else Ret.NOENTRY)
            return

        if timeout is not None and not self.rpc.no_response:
            self._deadline_entry = ctx.add_deadline(
                time.monotonic() + timeout, lambda: complete(Ret.TIMEOUT))

        # reply-to address for the target handle (origin/target symmetry:
        # the handler may forward back to us through the same machinery)
        local = hg.na.local_uris()
        origin_addr = self.info.addr
        if local:
            try:
                origin_addr = thg.na.addr_lookup(local[0])
            except MercuryError:
                pass

        th = Handle(thg, HandleInfo(origin_addr, self.rpc.rpc_id,
                                    thg.context), tinfo)
        th.cookie = self.cookie
        th.budget_ms = budget_ms
        th.arrived = time.monotonic()
        # self-tier: the trace context object is handed across directly —
        # no serialization, matching the value fast path it instruments
        th.trace_ctx = _trace.current()
        th._input = _copy.deepcopy(input_value) if copy else input_value
        th._input_decoded = True

        def deliver(ret: Ret, output: Any):
            if ret == Ret.SUCCESS:
                complete(Ret.SUCCESS,
                         _copy.deepcopy(output) if copy else output)
            else:
                # wire parity: error responses carry only str(output)
                complete(ret, None if output is None else str(output))

        th._local_deliver = deliver

        if self.rpc.no_response:
            # fire-and-forget: "handed over" is what SUCCESS means on the
            # wire path too (send completion, not handler completion)
            complete(Ret.SUCCESS)

        # The handler runs on the calling thread; Engine-registered
        # non-inline handlers immediately hop to the worker pool, so slow
        # work never blocks forward() (and deadlines still fire from the
        # progress thread).  Error mapping mirrors _dispatch's run().
        try:
            tinfo.handler(th)
        except MercuryError as e:
            if not tinfo.no_response and not th.responded:
                th.respond(str(e), ret=e.ret)
        except Exception as e:
            if not tinfo.no_response and not th.responded:
                th.respond(f"{type(e).__name__}: {e}", ret=Ret.FAULT)

    def cancel(self) -> None:
        """Cancel an in-flight forward.  The forward's completion callback
        fires with ``Ret.CANCELED`` (exactly once — a response racing the
        cancel wins whichever grabs the completion lock first), so futures
        layered on top always resolve; this is what lets hedged requests
        abandon the loser."""
        if self._recv_op is not None:
            self.hg.na.cancel(self._recv_op)
        if self._complete is not None:
            self._complete(Ret.CANCELED)
            return
        # not forwarded yet: mark completed so a later forward is a no-op
        with self._lock:
            if self._completed:
                return
            self._completed = True
        self._release_payload()
        self.ret = Ret.CANCELED
        if self._deadline_entry is not None:
            self.info.context.disarm(self._deadline_entry)

    # ------------------------------------------------------------------ target
    def remaining_budget(self) -> Optional[float]:
        """Seconds left of the caller's deadline budget (header
        ``budget_ms`` minus the time this request has already spent on the
        target), or ``None`` if the caller set no deadline.  Never
        negative: an already-blown budget reads 0.0."""
        if not self.budget_ms:
            return None
        return max(self.budget_ms / 1e3 - (time.monotonic() - self.arrived),
                   0.0)

    def get_input(self) -> Any:
        if not self._input_decoded:
            self._input = hg_proc.decode(self.rpc.in_proc, self._input_raw)
            self._input_decoded = True
        return self._input

    def respond(self, output: Any = None, ret: Ret = Ret.SUCCESS,
                cb: Optional[Callback] = None) -> None:
        if self.rpc.no_response:
            raise MercuryError(Ret.INVALID_ARG, "RPC registered as NO_RESPONSE")
        if self.responded:
            raise MercuryError(Ret.INVALID_ARG, "respond() called twice")
        if self._local_deliver is not None:
            # self-tier fast path: hand the output value straight to the
            # origin's completion (no encode, no expected-message send)
            self.responded = True
            self._local_deliver(ret, output)
            if cb is not None:
                cb(CallbackInfo(OpType.RESPOND, Ret.SUCCESS, handle=self))
            return
        hg = self.hg
        if ret == Ret.SUCCESS:
            payload = hg_proc.encode(self.rpc.out_proc, output) \
                if output is not None else b""
        else:
            payload = hg_proc.encode(hg_proc.proc_str, str(output)) \
                if output is not None else b""
        crc = payload_crc32(payload) if hg.checksum_payloads and payload else 0
        hdr = ResponseHeader(self.cookie, ret, len(payload), crc,
                             version=self.peer_version)

        ctx = self.info.context

        def on_sent(send_ret: Ret):
            ctx.completion_add(cb, CallbackInfo(OpType.RESPOND, send_ret,
                                                handle=self))

        # may raise MSGSIZE: leave ``responded`` unset so the handler's
        # error path can still send a (small) failure response
        hg.na.msg_send_expected(self.info.addr, (hdr.pack(), payload),
                                self.cookie, on_sent)
        self.responded = True


class HGClass:
    """Top-level RPC class: owns the NA plugin, the registration table and
    the default execution context (more can be created)."""

    def __init__(self, na: NAPlugin, checksum_payloads: bool = True,
                 unexpected_prepost: int = 8, copy_local: bool = True,
                 local_dispatch: bool = True):
        self.na = na
        self.checksum_payloads = checksum_payloads
        # Self-tier fast path knobs (DESIGN.md §9): ``local_dispatch``
        # gates the serialization-free in-process path entirely;
        # ``copy_local`` keeps wire-equivalent value isolation on it
        # (deep-copy request/response values).  ``copy_local=False`` with
        # checksums off on both sides yields true zero-copy handoff —
        # caller and handler then share the objects.
        self.copy_local = copy_local
        self.local_dispatch = local_dispatch
        self.registered: Dict[int, RPCInfo] = {}
        self._by_name: Dict[str, RPCInfo] = {}
        self._cookie_counter = _Counter()
        self.context = Context(na)
        self._unexpected_prepost = unexpected_prepost
        self._listening = False
        self._local_uris: list = []

    # -- registration -----------------------------------------------------------
    def register(self, name: str,
                 in_proc: hg_proc.Proc = hg_proc.proc_any,
                 out_proc: hg_proc.Proc = hg_proc.proc_any,
                 handler: Optional[Callable[[Handle], None]] = None,
                 no_response: bool = False) -> int:
        rpc_id = stable_rpc_id(name)
        info = RPCInfo(name, rpc_id, in_proc, out_proc, handler, no_response)
        existing = self.registered.get(rpc_id)
        if existing is not None and existing.name != name:
            raise MercuryError(Ret.INVALID_ARG,
                               f"rpc id collision: {name} vs {existing.name}")
        self.registered[rpc_id] = info
        self._by_name[name] = info
        return rpc_id

    def is_registered(self, name: str) -> bool:
        return name in self._by_name

    def lookup(self, uri: str) -> NAAddress:
        return self.na.addr_lookup(uri)

    def addr_self(self) -> NAAddress:
        return self.na.addr_self()

    # -- origin side --------------------------------------------------------------
    def create(self, addr: NAAddress, name: str) -> Handle:
        info = self._by_name.get(name)
        if info is None:
            raise MercuryError(Ret.NOENTRY, f"rpc not registered: {name}")
        return Handle(self, HandleInfo(addr, info.rpc_id, self.context), info)

    # -- target side ----------------------------------------------------------------
    def listen(self) -> None:
        """Arm the dispatcher: pre-post unexpected receives (re-posted on
        each arrival so there are always ``unexpected_prepost`` armed)."""
        if self._listening:
            return
        self._listening = True
        if self.local_dispatch:
            uris = self.na.local_uris()
            with _LOCAL_LOCK:
                for u in uris:
                    _LOCAL_DISPATCH[u] = self
            self._local_uris = uris
        for _ in range(self._unexpected_prepost):
            self._post_unexpected()

    def _post_unexpected(self) -> None:
        self.na.msg_recv_unexpected(self._on_unexpected)

    def _on_unexpected(self, ret: Ret, source: NAAddress, tag: int,
                       data: memoryview) -> None:
        # keep the pipeline of posted receives full
        if self._listening:
            self._post_unexpected()
        if ret != Ret.SUCCESS:
            return
        try:
            hdr = RequestHeader.unpack(data)
        except MercuryError:
            return
        # v4 peers send the shorter legacy header: slice the body at the
        # *decoded* header size, never at the v5 constant
        body = data[hdr.wire_size:]
        info = self.registered.get(hdr.rpc_id)

        if info is None:
            if not (hdr.flags & Flags.NO_RESPONSE):
                rhdr = ResponseHeader(hdr.cookie, Ret.NOENTRY, 0, 0,
                                      version=hdr.version)
                self.na.msg_send_expected(source, rhdr.pack(), hdr.cookie,
                                          lambda r: None)
            return

        if hdr.flags & Flags.RENDEZVOUS:
            self._pull_then_dispatch(info, hdr, source, body)
        else:
            self._dispatch(info, hdr, source, body)

    def _pull_then_dispatch(self, info: RPCInfo, hdr: RequestHeader,
                            source: NAAddress, desc_bytes: memoryview) -> None:
        """Oversized request: the body is a bulk descriptor — pull the real
        payload one-sidedly (zero-copy on native-RMA plugins), then proceed
        exactly as the eager path."""

        def fail(ret: Ret) -> None:
            if not (hdr.flags & Flags.NO_RESPONSE):
                rhdr = ResponseHeader(hdr.cookie, ret, 0, 0,
                                      version=hdr.version)
                self.na.msg_send_expected(source, rhdr.pack(), hdr.cookie,
                                          lambda r: None)

        try:
            desc = BulkDescriptor.from_bytes(desc_bytes)
        except Exception:
            fail(Ret.PROTOCOL_ERROR)
            return
        # the descriptor is peer-controlled: allocate only what the header
        # declared, and refuse disagreement instead of trusting desc.size
        if desc.size != hdr.payload_len:
            fail(Ret.PROTOCOL_ERROR)
            return
        try:
            buf = bytearray(desc.size)
            lh = BulkHandle(self.na, [buf], read=True, write=True)
        except (MemoryError, MercuryError):
            fail(Ret.NOMEM)
            return

        def on_pulled(cbinfo: CallbackInfo):
            lh.free()
            if cbinfo.ret != Ret.SUCCESS:
                fail(cbinfo.ret)
                return
            self._dispatch(info, hdr, source, memoryview(buf))

        try:
            # a plugin may raise synchronously from put/get (sm does for
            # unreachable registrations) — keep that off the progress thread
            bulk_transfer(self.context, BulkOpType.GET, source, desc, 0, lh,
                          0, desc.size, on_pulled)
        except MercuryError as e:
            lh.free()
            fail(e.ret)

    def _dispatch(self, info: RPCInfo, hdr: RequestHeader, source: NAAddress,
                  body: memoryview) -> None:
        handle = Handle(self, HandleInfo(source, hdr.rpc_id, self.context), info)
        handle.cookie = hdr.cookie
        handle._input_raw = body
        handle.budget_ms = hdr.budget_ms
        handle.arrived = time.monotonic()
        handle.peer_version = hdr.version
        if hdr.span_id:
            handle.trace_ctx = _trace.TraceContext(
                hdr.trace_id, hdr.span_id, hdr.trace_flags)

        if (hdr.flags & Flags.CHECKSUM) and self.checksum_payloads and hdr.payload_len:
            if payload_crc32(body) != hdr.payload_crc:
                if not (hdr.flags & Flags.NO_RESPONSE):
                    handle.respond(None, ret=Ret.CHECKSUM_ERROR)
                return

        if info.handler is None:
            if not (hdr.flags & Flags.NO_RESPONSE):
                handle.respond(None, ret=Ret.NOENTRY)
            return

        # Paper C5: the handler callback is *placed onto the completion
        # queue* before being executed (by trigger()).
        def run(_info: CallbackInfo):
            try:
                info.handler(handle)
            except MercuryError as e:
                if not info.no_response and not handle.responded:
                    handle.respond(str(e), ret=e.ret)
            except Exception as e:  # handler fault → FAULT response
                if not info.no_response and not handle.responded:
                    handle.respond(f"{type(e).__name__}: {e}", ret=Ret.FAULT)

        self.context.completion_add(
            run, CallbackInfo(OpType.RPC_HANDLER, Ret.SUCCESS, handle=handle))

    def finalize(self) -> None:
        self._listening = False
        if self._local_uris:
            with _LOCAL_LOCK:
                for u in self._local_uris:
                    if _LOCAL_DISPATCH.get(u) is self:
                        del _LOCAL_DISPATCH[u]
            self._local_uris = []
        self.na.finalize()
