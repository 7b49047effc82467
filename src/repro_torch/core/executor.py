"""Executor shims (paper C5, second half).

The paper: the callback/completion-queue core "allows definition ... of
shim layers that simplify common cases, based for instance on a request
model to provide post/test operations" and "a multithreaded execution
model". Both are built here *on top of* the unchanged core:

  * :class:`Engine` — owns an HGClass; a daemon *progress thread* spins
    ``progress``; triggered callbacks dispatch RPC handlers onto a
    thread-pool (multithreaded execution model).
  * :meth:`Engine.call` / :meth:`Engine.call_async` — request-model shim
    (post/wait → blocking call; post/test → Future).
  * Bulk helpers (``expose`` / ``pull`` / ``push``) — one-call wrappers
    over the bulk layer with blocking semantics for handler code.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from . import proc as hg_proc
from .bulk import (BulkDescriptor, BulkHandle, BulkOp, BulkOpType,
                   bulk_transfer, expose_arrays)
from .na import initialize
from .na.base import NAAddress, NAPlugin
from .progress import Context
from .rpc import Handle, HGClass
from .types import CallbackInfo, MercuryError, OpType, Ret
from ..telemetry import metrics as _metrics
from ..telemetry import trace as _trace

_M_CALLS = _metrics.counter("core.engine.calls")
_M_HANDLED = _metrics.counter("core.engine.handled")
_M_NOTIFIES = _metrics.counter("core.engine.notifies")


class RemoteError(MercuryError):
    """Raised at the origin when the target handler faulted."""

    def __init__(self, ret: Ret, detail: str = ""):
        super().__init__(ret, detail)
        self.detail = detail


class CallFuture(cf.Future):
    """Future returned by :meth:`Engine.call_async`; carries the underlying
    RPC handle so callers (hedged requests, pools) can abandon the call."""

    handle: Optional[Handle] = None

    def cancel_call(self) -> None:
        """Cancel the in-flight RPC; the future resolves with a
        ``Ret.CANCELED`` :class:`RemoteError` (unless the response won the
        race, in which case the result stands)."""
        if self.handle is not None:
            self.handle.cancel()


class Engine:
    """A service node runtime: progress thread + handler pool + call shims.

    Every Engine is simultaneously an origin and a target (paper C4): it
    can ``register`` handlers and ``call`` remote ones.
    """

    def __init__(self, uri: Optional[str | Sequence[str]] = None,
                 listen: bool = True,
                 handler_threads: int = 4, checksum: bool = True,
                 progress_interval: float = 0.05, copy_local: bool = True,
                 local_dispatch: bool = True):
        """``uri`` may be one transport URI, a semicolon-joined address set
        (``"self://a;sm://a;tcp://127.0.0.1:0"``) or a list of URIs; multi-
        transport engines resolve each target to its cheapest tier.

        ``local_dispatch``/``copy_local`` tune the self-tier fast path
        (DESIGN.md §9): co-located calls skip serialization entirely;
        ``copy_local=False`` (with ``checksum=False`` on both ends)
        additionally shares values zero-copy instead of deep-copying."""
        self.na: NAPlugin = initialize(uri, listen=listen)
        self.hg = HGClass(self.na, checksum_payloads=checksum,
                          copy_local=copy_local,
                          local_dispatch=local_dispatch)
        self.ctx: Context = self.hg.context
        self._pool = cf.ThreadPoolExecutor(max_workers=handler_threads,
                                           thread_name_prefix="hg-handler")
        self._stop = threading.Event()
        self._progress_interval = progress_interval
        self._addr_cache: Dict[str, NAAddress] = {}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"hg-progress[{self.uri}]")
        if listen:
            self.hg.listen()
            self._register_telemetry_rpcs()
        self._thread.start()

    def _register_telemetry_rpcs(self) -> None:
        """Every listening engine serves the telemetry plane uniformly:
        ``dbg.trace`` (span ring snapshot — clients reassemble the
        cross-process span tree by unioning these) and ``fab.metrics``
        (the process-global metrics registry)."""
        self.register(
            "dbg.trace",
            lambda req: _trace.export(trace_id=(req or {}).get("trace_id"),
                                      limit=(req or {}).get("limit")),
            inline=True)
        self.register(
            "fab.metrics",
            lambda _req: {"pid": os.getpid(), "uri": self.uri,
                          "metrics": _metrics.snapshot()},
            inline=True)

    # ------------------------------------------------------------------ runtime
    @property
    def uri(self) -> str:
        return self.na.addr_self().uri

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.ctx.progress(self._progress_interval)
                # Trigger everything currently queued. RPC handler entries
                # hop to the pool inside their wrapper (see register()).
                self.ctx.trigger()
            except Exception:
                if self._stop.is_set():
                    return
                import traceback
                traceback.print_exc()

    def shutdown(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self.na.interrupt()
        self._thread.join(timeout=2.0)
        self._pool.shutdown(wait=False)
        self.hg.finalize()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------------ target
    def register(self, name: str, fn: Callable[..., Any],
                 in_proc: hg_proc.Proc = hg_proc.proc_any,
                 out_proc: hg_proc.Proc = hg_proc.proc_any,
                 no_response: bool = False,
                 pass_handle: bool = False,
                 inline: bool = False) -> None:
        """Register ``fn(input) -> output`` as an RPC handler.  By default
        the handler hops to the thread pool (safe for blocking work);
        ``inline=True`` executes it directly on the progress thread — the
        low-latency path for cheap, non-blocking handlers (the handler
        MUST NOT block or issue nested blocking RPCs).

        Every handler execution is a *server span* of the wire-propagated
        trace (no-op unless the request carried a sampled context), and
        the request's context is installed as the thread's ambient context
        for the handler's duration — nested calls (service chains, the
        registry's write-proxy hop) inherit it automatically."""

        def handler(handle: Handle) -> None:
            def work():
                _M_HANDLED.inc()
                span = _trace.start_span(f"rpc.{name}", handle.trace_ctx)
                if span.recorded:
                    span.annotate(
                        engine=self.uri, budget_ms=handle.budget_ms,
                        queue_ms=round(
                            (time.monotonic() - handle.arrived) * 1e3, 3),
                        local=handle._local_deliver is not None)
                tok = _trace.activate(span.ctx)
                status = "OK"
                try:
                    value = handle.get_input()
                    if pass_handle:
                        out = fn(value, handle)
                        if handle.responded or handle.deferred or no_response:
                            return
                    else:
                        out = fn(value)
                    if not no_response:
                        handle.respond(out)
                except MercuryError as e:
                    status = e.ret.name
                    if not no_response and not handle.responded:
                        handle.respond(str(e), ret=e.ret)
                except Exception as e:
                    status = "FAULT"
                    if not no_response and not handle.responded:
                        handle.respond(f"{type(e).__name__}: {e}", ret=Ret.FAULT)
                finally:
                    _trace.restore(tok)
                    span.finish(status)
            if inline:
                work()
            else:
                self._pool.submit(work)

        self.hg.register(name, in_proc, out_proc, handler,
                         no_response=no_response)

    # ------------------------------------------------------------------ origin
    def lookup(self, uri: str) -> NAAddress:
        addr = self._addr_cache.get(uri)
        if addr is None:
            addr = self.hg.lookup(uri)
            self._addr_cache[uri] = addr
        return addr

    def _ensure_registered(self, name: str) -> None:
        # Origin side only needs procs; default proc_any if unseen.
        if not self.hg.is_registered(name):
            self.hg.register(name)

    def call_async(self, target: str | NAAddress, name: str, arg: Any = None,
                   timeout: Optional[float] = 30.0,
                   deadline: Optional[float] = None) -> CallFuture:
        """Post an RPC; resolve a Future with the decoded output.

        ``deadline`` (absolute ``time.monotonic()`` value) overrides
        ``timeout``: the transport timeout becomes the time remaining, and
        an already-expired deadline fails fast without touching the wire.
        The returned :class:`CallFuture` supports ``cancel_call()``.
        """
        fut = CallFuture()
        _M_CALLS.inc()
        if deadline is not None:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                fut.set_exception(RemoteError(Ret.TIMEOUT,
                                              f"{name}: deadline expired"))
                return fut
        self._ensure_registered(name)
        addr = self.lookup(target) if isinstance(target, str) else target
        handle = self.hg.create(addr, name)
        fut.handle = handle

        def on_complete(info: CallbackInfo):
            h: Handle = info.handle
            if info.ret != Ret.SUCCESS or h.ret != Ret.SUCCESS:
                ret = info.ret if info.ret != Ret.SUCCESS else h.ret
                detail = str(h.output) if h.output else name
                fut.set_exception(RemoteError(ret, detail))
            else:
                fut.set_result(h.output)

        handle.forward(arg, on_complete, timeout=timeout)
        return fut

    def call(self, target: str | NAAddress, name: str, arg: Any = None,
             timeout: Optional[float] = 30.0,
             deadline: Optional[float] = None) -> Any:
        """Blocking request-model shim (post/wait)."""
        if deadline is not None:
            # pass through: an already-expired deadline fails fast inside
            # call_async without putting the request on the wire
            fut = self.call_async(target, name, arg, deadline=deadline)
            grace = max(deadline - time.monotonic(), 0.0) + 5.0
            return fut.result(timeout=grace)
        fut = self.call_async(target, name, arg, timeout=timeout)
        # +grace so transport-level timeout fires first with a precise code
        return fut.result(timeout=None if timeout is None else timeout + 5.0)

    def notify(self, target: str | NAAddress, name: str, arg: Any = None) -> None:
        """Fire-and-forget RPC (NO_RESPONSE flag)."""
        _M_NOTIFIES.inc()
        if not self.hg.is_registered(name):
            self.hg.register(name, no_response=True)
        addr = self.lookup(target) if isinstance(target, str) else target
        handle = self.hg.create(addr, name)
        handle.forward(None if arg is None else arg, None)

    # ------------------------------------------------------------------ bulk
    def expose(self, arrays: Sequence[np.ndarray], read: bool = True,
               write: bool = True) -> BulkHandle:
        return expose_arrays(self.na, arrays, read=read, write=write)

    def _transfer(self, op: BulkOpType, origin: str | NAAddress,
                  desc: BulkDescriptor, local: BulkHandle,
                  remote_offset: int = 0, local_offset: int = 0,
                  size: Optional[int] = None, timeout: float = 60.0,
                  chunk_size: int = 4 * 1024 * 1024,
                  max_inflight: int = 4) -> None:
        if size is None:
            size = min(desc.size - remote_offset, local.size - local_offset)
        addr = self.lookup(origin) if isinstance(origin, str) else origin
        done = threading.Event()
        box = {}

        def cb(info: CallbackInfo):
            box["ret"] = info.ret
            done.set()

        bulk_transfer(self.ctx, op, addr, desc, remote_offset, local,
                      local_offset, size, cb, chunk_size=chunk_size,
                      max_inflight=max_inflight)
        if not done.wait(timeout):
            raise MercuryError(Ret.TIMEOUT, "bulk transfer timed out")
        if box["ret"] != Ret.SUCCESS:
            raise MercuryError(box["ret"], "bulk transfer failed")

    def pull(self, origin: str | NAAddress, desc: BulkDescriptor,
             local: BulkHandle, **kw) -> None:
        """One-sided GET: remote (descriptor) → local handle."""
        self._transfer(BulkOpType.GET, origin, desc, local, **kw)

    def push(self, origin: str | NAAddress, desc: BulkDescriptor,
             local: BulkHandle, **kw) -> None:
        """One-sided PUT: local handle → remote (descriptor)."""
        self._transfer(BulkOpType.PUT, origin, desc, local, **kw)
