"""Data-feed service: a feeder process hosts the token pipeline; trainer
processes fetch batches over RPC.  Ported from
``src/repro/services/datafeed.py``: batches are numpy, as there.

Small batches ride inline in the RPC response (eager); large ones go
through a bulk descriptor the trainer pulls one-sidedly — the
eager/rendezvous crossover is a constructor knob and is *benchmarked* in
``benchmarks/bench_bulk.py`` (the paper's bulk-vs-eager trade-off).

The client keeps ``depth`` requests outstanding (async prefetch), so one
slow feeder response never stalls the training step; combined with
``replicated_call`` over several feeders it is the datapath side of
straggler mitigation.

A ``get`` is a ``datafeed.get`` region for ``torch.profiler``
(``telemetry.trace.region``), holding its block on the RPC
(``datafeed.wait``, with the step) and a bulk batch's one-sided pull
(``datafeed.pull``); the block's milliseconds also go to the registry's
``service.datafeed.wait_ms`` histogram, which ``fab.metrics`` exports.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.bulk import BulkDescriptor
from ..core.executor import Engine
from ..telemetry import metrics as _metrics
from ..telemetry import trace as _trace
from .base import alloc_from_manifest, manifest_of

EAGER_LIMIT = 256 * 1024

_M_WAIT_MS = _metrics.histogram("service.datafeed.wait_ms")


class DataFeedServer:
    def __init__(self, engine: Engine, source, eager_limit: int = EAGER_LIMIT,
                 keep: int = 8, registry: Optional[str] = None,
                 service: str = "feed"):
        self.engine = engine
        self.source = source                     # needs .batch_at(step)
        self.eager_limit = eager_limit
        self._exposed = collections.OrderedDict()  #: guarded-by _lock
        self._keep = keep
        self._lock = threading.Lock()
        engine.register("feed.get", self._get)
        engine.register("feed.spec", self._spec)
        self.instance = None
        if registry is not None:
            from ..fabric.registry import ServiceInstance
            self.instance = ServiceInstance(engine, registry, service)

    def close(self) -> None:
        if self.instance is not None:
            self.instance.close()

    def _spec(self, _req):
        b = self.source.batch_at(0)
        return {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                for k, v in b.items()}

    def _get(self, req):
        step = int(req["step"])
        batch = self.source.batch_at(step)
        total = sum(v.nbytes for v in batch.values())
        if total <= self.eager_limit:
            return {"mode": "eager", "step": step, "batch": batch}
        with self._lock:
            if step not in self._exposed:
                named = {k: np.ascontiguousarray(v)
                         for k, v in batch.items()}
                handle = self.engine.expose(list(named.values()),
                                            read=True, write=False)
                self._exposed[step] = (named, handle)
                while len(self._exposed) > self._keep:
                    _, (_, old) = self._exposed.popitem(last=False)
                    old.free()
            named, handle = self._exposed[step]
        return {"mode": "bulk", "step": step,
                "manifest": manifest_of(named),
                "desc": handle.descriptor().to_bytes(),
                "origin": self.engine.uri}


class DataFeedClient:
    def __init__(self, engine: Engine, feeders: Optional[List[str]] = None,
                 depth: int = 2, registry: Optional[str] = None,
                 service: str = "feed"):
        """``feeders`` is an explicit URI list, or pass ``registry=`` to
        resolve every live instance of ``service`` by name."""
        if feeders is None:
            if registry is None:
                raise ValueError("need feeders or registry")
            from ..fabric.registry import resolve_service_uris
            feeders = resolve_service_uris(engine, registry, service)
        self.engine = engine
        self.feeders = feeders
        self.depth = depth
        self._pending: Dict[int, object] = {}
        self._next_issue = 0

    def _issue(self, step: int):
        feeder = self.feeders[step % len(self.feeders)]
        self._pending[step] = self.engine.call_async(
            feeder, "feed.get", {"step": step}, timeout=60.0)

    def get(self, step: int) -> Dict[str, np.ndarray]:
        with _trace.region("datafeed.get"):
            # keep the window [step, step+depth) outstanding
            for s in range(step, step + self.depth):
                if s not in self._pending and s >= self._next_issue:
                    self._issue(s)
                    self._next_issue = max(self._next_issue, s + 1)
            fut = self._pending.pop(step, None)
            if fut is None:
                self._issue(step)
                fut = self._pending.pop(step)
            t0 = time.monotonic()
            with _trace.region("datafeed.wait", step=step):
                rsp = fut.result(timeout=120.0)
            _M_WAIT_MS.observe((time.monotonic() - t0) * 1e3)
            if rsp["mode"] == "eager":
                return {k: np.asarray(v) for k, v in rsp["batch"].items()}
            man = rsp["manifest"]
            named = alloc_from_manifest(man)
            with _trace.region("datafeed.pull", step=step):
                local = self.engine.expose(list(named.values()), read=False,
                                           write=True)
                try:
                    self.engine.pull(rsp["origin"],
                                     BulkDescriptor.from_bytes(rsp["desc"]),
                                     local)
                finally:
                    local.free()
            return named
