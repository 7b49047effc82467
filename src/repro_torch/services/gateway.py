"""Serving gateway: the Mercury RPC front door for the ServeEngine,
ported from ``src/repro/services/gateway.py`` onto the port's own RPC
core and engine.

RPCs:
  ``gen.submit``   {tokens, max_new, temperature, eos_id
                   [, session_id]} → {rid}      (non-blocking enqueue)
                   ``session_id`` keys the engine's KV-session table: a
                   follow-up turn whose prompt extends the cached history
                   resumes from the pinned KV instead of re-prefilling
                   (see serve/engine.py); the fabric's SessionAffinity
                   layer keeps follow-ups on the KV-holding replica
  ``gen.submit_bulk`` {desc, count, ...} — the prompt tokens stay in the
                   client's registered memory; the gateway pulls them
                   one-sidedly (zero-copy on sm/self transports) instead
                   of carrying them in the eager message
  ``gen.result``   {rid[, wait, timeout]} → {tokens, done} — with
                   ``wait`` the response is sent *event-driven* from the
                   request's done callback (deadline timer for the
                   timeout), so a parked waiter costs no handler thread
  ``gen.generate`` blocking submit+wait (handler parks on the request's
                   done event — it runs on the engine's handler pool, so
                   the progress thread keeps spinning: exactly the
                   multithreaded-executor shim of paper C5)
  ``gen.stats``    → queue/slot utilization + load (the fabric's
                   piggybacked balancing signal) + admission stats

A background thread drives ``ServeEngine.step()`` whenever work exists
(woken by the engine's work event — no idle polling).  Self-registration
with a fabric registry (``registry=``, ``member_id=``) is not ported yet
and raises ``NotImplementedError``.

**Deadline-aware admission control**: every submit path (``gen.submit``,
``gen.submit_bulk``, ``gen.generate``) runs through a shared
:class:`~.admission.AdmissionController` first.  The caller's
remaining deadline budget arrives in the request header
(``Handle.remaining_budget``); if the gateway's backlog × EWMA service
time says the request cannot finish in that budget, it is shed with
``Ret.OVERLOAD`` *before* touching the serve queue — an overloaded
server spends its capacity on requests that can still make their
deadlines, and the client pool re-routes the shed ones immediately.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from ..core.bulk import BulkDescriptor
from ..core.executor import Engine
from ..core.types import Ret
from ..serve.engine import Request, ServeEngine
from ..telemetry import metrics as _metrics
from ..telemetry import trace as _trace
from .admission import AdmissionController

# unified metrics: gateway serve-path totals (fab.metrics exports these;
# the per-gateway view stays in gen.stats)
_M_SUBMITS = _metrics.counter("service.gateway.submits")
_M_COMPLETIONS = _metrics.counter("service.gateway.completions")
_M_TOKENS_OUT = _metrics.counter("service.gateway.tokens_out")
_M_QUEUE_MS = _metrics.histogram("service.gateway.queue_ms")
_M_SERVICE_MS = _metrics.histogram("service.gateway.service_ms")


class ServingGateway:
    def __init__(self, engine: Engine, serve: ServeEngine,
                 registry: Optional[str] = None, service: str = "gen",
                 admission: Optional[AdmissionController] = None,
                 shed_enabled: bool = True,
                 member_id: Optional[str] = None):
        if registry is not None or member_id is not None:
            raise NotImplementedError(
                "fabric registration (registry=/member_id=) is not ported "
                "yet: the port's fabric/ is a later slice")
        self.engine = engine
        self.serve = serve
        self.service = service
        self.requests: Dict[int, Request] = {}  #: guarded-by _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.steps = 0  #: guarded-by _lock
        self.admission = admission or AdmissionController()
        self.shed_enabled = shed_enabled
        engine.register("gen.submit", self._submit, pass_handle=True)
        engine.register("gen.submit_bulk", self._submit_bulk,
                        pass_handle=True)
        engine.register("gen.result", self._result, pass_handle=True)
        engine.register("gen.generate", self._generate, pass_handle=True)
        engine.register("gen.stats", self._stats)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _load(self) -> float:
        """The piggybacked balancing signal: in-flight slot occupancy +
        queue depth + pinned-session pressure.  Pinned sessions hold no
        ``slot_req`` — a gateway whose batch is entirely pinned KV would
        report near-idle on active+queued alone, yet admitting a fresh
        request there costs an eviction (and some other session its
        cache), so they count at half weight."""
        s = self.serve.stats()
        return float(s["active_slots"] + s["queued"]
                     + 0.5 * s["pinned_sessions"])

    def _admit(self, handle) -> None:
        """Deadline-aware admission: shed with ``Ret.OVERLOAD`` when the
        backlog × EWMA service time says this request cannot finish
        within the caller's remaining deadline budget."""
        if not self.shed_enabled:
            return
        s = self.serve.stats()
        self.admission.admit(handle.remaining_budget(),
                             backlog=s["active_slots"] + s["queued"],
                             parallelism=max(s["n_slots"], 1))

    def _enqueue(self, req_in) -> Request:
        t0 = time.monotonic()
        req = self.serve.submit(
            np.asarray(req_in["tokens"], np.int32),
            max_new=int(req_in.get("max_new", 32)),
            temperature=float(req_in.get("temperature", 0.0)),
            eos_id=int(req_in.get("eos_id", -1)),
            session_id=req_in.get("session_id"))
        with self._lock:
            self.requests[req.rid] = req
        # feed the admission EWMA from every completion.  The EWMA that
        # drives shedding is PURE service time — measured from the
        # engine's slot-admission stamp (t_admit), not from submit —
        # because queue wait is already priced in via the backlog term;
        # measuring submit→done would double-count queueing right after
        # a burst and over-shed until the EWMA re-converged.  submit→done
        # is still recorded separately (ema_turnaround_ms in gen.stats).
        t_in = req.t_submit or t0
        _M_SUBMITS.inc()
        # the serve span outlives the RPC handler (gen.submit returns a
        # rid immediately): child of the ambient server span, finished
        # from the request's done callback with queue/service timings
        # split on the engine's slot-admission stamp
        span = _trace.start_span(f"{self.service}.serve", _trace.current())

        def _observe():
            now = time.monotonic()
            queue_s = max((req.t_admit or t_in) - t_in, 0.0)
            service_s = now - (req.t_admit or t_in)
            self.admission.observe(service_s, turnaround_s=now - t_in)
            _M_COMPLETIONS.inc()
            _M_TOKENS_OUT.inc(len(req.out_tokens))
            _M_QUEUE_MS.observe(queue_s * 1e3)
            _M_SERVICE_MS.observe(service_s * 1e3)
            if span.recorded:
                span.annotate(rid=req.rid,
                              queue_ms=round(queue_s * 1e3, 3),
                              service_ms=round(service_s * 1e3, 3),
                              new_tokens=len(req.out_tokens))
            span.finish("OK")

        req.add_done_callback(_observe)
        return req

    def _submit(self, req_in, handle):
        self._admit(handle)
        return {"rid": self._enqueue(req_in).rid}

    def _submit_bulk(self, req_in, handle):
        """Zero-copy submit: pull the prompt from the caller's registered
        memory (cheapest-tier transport chosen by address resolution)."""
        self._admit(handle)
        desc = BulkDescriptor.from_bytes(req_in["desc"])
        count = int(req_in.get("count", desc.size // 4))
        # count and the descriptor are client-controlled: never allocate
        # more than the descriptor can actually back
        if count < 0 or count * 4 > desc.size:
            raise ValueError(f"count {count} exceeds descriptor "
                             f"({desc.size} bytes)")
        tokens = np.empty(count, np.int32)
        lh = self.engine.expose([tokens])
        try:
            self.engine.pull(handle.info.addr, desc, lh,
                             size=count * 4)
        finally:
            lh.free()
        req_in = dict(req_in, tokens=tokens)
        out = {"rid": self._enqueue(req_in).rid}
        handle.respond(out)

    @staticmethod
    def _ttft_ms(req: Request) -> float:
        return round((req.t_first - req.t_submit) * 1e3, 3) \
            if req.t_first else -1.0

    def _result_payload(self, rid: int, req: Request) -> dict:
        done = req.done_event.is_set()
        out = {"tokens": list(req.out_tokens), "done": done,
               "ttft_ms": self._ttft_ms(req)}
        if done:
            with self._lock:
                self.requests.pop(rid, None)
        return out

    def _result(self, req_in, handle):
        rid = int(req_in["rid"])
        with self._lock:
            req = self.requests.get(rid)
        if req is None:
            handle.respond({"error": "unknown rid"})
            return
        if not req_in.get("wait") or req.done_event.is_set():
            handle.respond(self._result_payload(rid, req))
            return
        # Waiting path: respond from the request's done callback (or the
        # deadline timer) instead of parking this handler-pool thread.
        handle.deferred = True
        once = threading.Lock()
        state = {"sent": False}

        def finish():
            with once:
                if state["sent"]:
                    return
                state["sent"] = True
            try:
                handle.respond(self._result_payload(rid, req))
            except Exception as e:
                # e.g. MSGSIZE on a huge token payload: report instead of
                # letting the error escape into the caller's thread (the
                # serve step loop or the progress thread's deadline sweep)
                try:
                    if not handle.responded:
                        handle.respond(f"{type(e).__name__}: {e}",
                                       ret=Ret.FAULT)
                except Exception:
                    pass

        entry = self.engine.ctx.add_deadline(
            time.monotonic() + float(req_in.get("timeout", 60.0)), finish)

        def on_done():
            self.engine.ctx.disarm(entry)
            finish()

        req.add_done_callback(on_done)

    def _generate(self, req_in, handle):
        self._admit(handle)
        req = self._enqueue(req_in)
        req.done_event.wait(float(req_in.get("timeout", 120.0)))
        with self._lock:
            self.requests.pop(req.rid, None)
        return {"tokens": list(req.out_tokens),
                "done": req.done_event.is_set(),
                "ttft_ms": self._ttft_ms(req)}

    def _stats(self, _req):
        out = self.serve.stats()
        with self._lock:
            steps = self.steps
        lookups = out["prefix_hits"] + out["prefix_misses"]
        out.update(steps=steps, uris=self.engine.uri,
                   load=self._load(),
                   prefix_hit_rate=(out["prefix_hits"] / lookups
                                    if lookups else 0.0),
                   **self.admission.stats())
        return out

    def _loop(self):
        while not self._stop.is_set():
            n = self.serve.step()
            if n:
                with self._lock:
                    self.steps += 1
            if n == 0 and self.serve.pending() == 0:
                # park until the next submit (double-check after clearing
                # so a racing submit can't be missed; the bounded wait
                # caps the cost of any residual race)
                self.serve.work.clear()
                if self.serve.pending() == 0 and not self._stop.is_set():
                    self.serve.work.wait(0.05)

    def close(self):
        """Graceful stop: join the step loop (idempotent)."""
        if self._stop.is_set():
            return
        self._stop.set()
        self.serve.work.set()            # wake a parked step loop
        self._thread.join(timeout=2.0)

    stop = close
