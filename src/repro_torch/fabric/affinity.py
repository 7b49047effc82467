"""Session-affine routing over a :class:`~repro_torch.fabric.pool.ServicePool`.

Serving replicas keep per-conversation state worth returning to: the
engine pins a finished request's KV cache under its ``session_id``
(serve/engine.py), so a follow-up turn that lands on the *same* replica
re-prefills only the new tokens.  :class:`SessionAffinity` is the client
half of that contract — a small LRU map ``session_id → iid`` layered
over ``call_routed``:

  * **first turn**: no mapping — the pool's balancer routes normally and
    the winning iid is remembered;
  * **follow-up**: the remembered iid is passed as ``prefer=`` (soft
    affinity: front of the candidate ranking, NOT a pin);
  * **fallback**: if the preferred replica is dead, deregistered, shed
    the call, or lost the race to a hedge, the call lands wherever the
    balancer sends it — the serve there misses its session cache and
    does a fresh full prefill.  Correct, just slower; the map is then
    updated to the new home (a recorded ``move``).

Affinity is an *optimization hint* end to end: the engine never trusts a
hit (it verifies the cached token prefix), and this layer never insists
on a replica.  Losing every mapping (client restart, LRU overflow) costs
re-prefills, not errors.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

from ..telemetry import metrics as _metrics
from .pool import ServicePool

_M_HITS = _metrics.counter("fabric.affinity.hits")
_M_MISSES = _metrics.counter("fabric.affinity.misses")
_M_MOVES = _metrics.counter("fabric.affinity.moves")


class SessionAffinity:
    """LRU ``session_id → iid`` map steering follow-up calls back to the
    replica that holds the session's KV cache."""

    def __init__(self, pool: ServicePool, capacity: int = 4096):
        self.pool = pool
        self.capacity = capacity
        self._map: "OrderedDict[str, str]" = OrderedDict()  #: guarded-by _lock
        self._lock = threading.Lock()
        self.hits = 0     #: guarded-by _lock
        self.misses = 0   #: guarded-by _lock
        self.moves = 0    #: guarded-by _lock — follow-up served elsewhere

    def lookup(self, session_id: str) -> Optional[str]:
        with self._lock:
            iid = self._map.get(session_id)
            if iid is not None:
                self._map.move_to_end(session_id)
        return iid

    def _record(self, session_id: str, prefer: Optional[str],
                iid: Optional[str]) -> None:
        if iid is None:
            return
        with self._lock:
            if prefer is None:
                self.misses += 1
                _M_MISSES.inc()
            elif prefer == iid:
                self.hits += 1
                _M_HITS.inc()
            else:
                self.moves += 1          # preferred replica unavailable:
                _M_MOVES.inc()           # session re-homed, fresh prefill
            self._map[session_id] = iid
            self._map.move_to_end(session_id)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)

    def call_routed(self, session_id: str, rpc: str, arg: Any = None,
                    **kw) -> tuple:
        """Affine :meth:`ServicePool.call_routed`: returns
        ``(value, iid)`` and updates the session's home to ``iid``."""
        prefer = self.lookup(session_id)
        value, iid = self.pool.call_routed(rpc, arg, prefer=prefer, **kw)
        self._record(session_id, prefer, iid)
        return value, iid

    def call(self, session_id: str, rpc: str, arg: Any = None, **kw) -> Any:
        return self.call_routed(session_id, rpc, arg, **kw)[0]

    def forget(self, session_id: str) -> None:
        """Drop a mapping (conversation ended / server reported the
        session evicted) — the next turn routes by the balancer."""
        with self._lock:
            self._map.pop(session_id, None)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"sessions": len(self._map), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "moves": self.moves}
