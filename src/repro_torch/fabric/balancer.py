"""Pluggable load balancers for :class:`~repro_torch.fabric.pool.ServicePool`.

Contract (see DESIGN.md §7): a balancer is given the pool's live
:class:`Replica` views and returns them **ordered best-first**.  The pool
walks the ranking and places the call on the first replica that admits it
(credit available / reachable); retries continue down the list.  Ranking
instead of picking one replica is what lets flow control, retries and
hedging compose with any policy: the balancer never needs to know why a
candidate was rejected.

Balancers must be cheap and thread-safe — they run on every call.

  * ``rr``        round-robin over the replica set (stable under view
                  refreshes: position keyed by a monotonically advancing
                  counter, not list order)
  * ``least``     least-loaded first, using piggybacked registry load
                  reports combined with the pool's own live in-flight
                  counts (local counts lead, reports trail)
  * ``locality``  cheapest transport tier first (self < sm < tcp — the
                  NotNets argument: keep co-located traffic off the
                  network stack), least-loaded within a tier
  * ``weighted``  expected-wait ranking: ``ema_latency × (inflight + 1)
                  / capacity`` — client-side EWMA latency (fed from
                  ``Replica.record``) times queue occupancy (local
                  in-flight + the server's piggybacked ``fab.report``
                  load), normalized by capacity.  Unlike the strict
                  tier/load sort this trades tiers off against observed
                  speed, so a slow-but-local replica loses to a
                  fast-but-remote one once the latency gap exceeds the
                  transport gap
"""
from __future__ import annotations

import abc
import itertools
import threading
from typing import Dict, List, Sequence, Type


class Balancer(abc.ABC):
    @abc.abstractmethod
    def rank(self, replicas: Sequence["Replica"]) -> List["Replica"]:
        """Return ``replicas`` ordered best-first (must not mutate)."""

    @property
    def name(self) -> str:
        return type(self).__name__


class RoundRobin(Balancer):
    def __init__(self):
        self._counter = itertools.count()  #: guarded-by _lock
        self._lock = threading.Lock()

    def rank(self, replicas):
        if not replicas:
            return []
        with self._lock:
            n = next(self._counter)
        order = sorted(replicas, key=lambda r: r.iid)   # stable base order
        k = n % len(order)
        return order[k:] + order[:k]


def _effective_load(r) -> float:
    """Piggybacked registry load + what *we* currently have in flight
    there (the local signal is fresher than the last report)."""
    cap = max(r.capacity, 1)
    return (r.load + r.gate.inflight) / cap


def _rotate_ties(ordered: List["Replica"], keyfn, n: int) -> List["Replica"]:
    """Rotate the leading equal-cost group by ``n`` so replicas that are
    indistinguishable under ``keyfn`` share traffic instead of the
    deterministic sort funnelling every idle-period call to one of them."""
    if len(ordered) < 2:
        return ordered
    k0 = keyfn(ordered[0])
    i = 1
    while i < len(ordered) and keyfn(ordered[i]) == k0:
        i += 1
    k = n % i
    return ordered[k:i] + ordered[:k] + ordered[i:]


class LeastLoaded(Balancer):
    def __init__(self):
        self._counter = itertools.count()  #: guarded-by _lock
        self._lock = threading.Lock()

    def rank(self, replicas):
        key = _effective_load
        base = sorted(replicas, key=lambda r: (key(r), r.iid))
        with self._lock:
            n = next(self._counter)
        return _rotate_ties(base, key, n)


class LocalityAware(Balancer):
    """Prefer cheaper transport tiers; break ties by load.  A replica
    whose cheap tier was demoted (stale sm segment, dead self peer)
    naturally sinks in the ranking because its resolved tier rose."""

    def __init__(self):
        self._counter = itertools.count()  #: guarded-by _lock
        self._lock = threading.Lock()

    def rank(self, replicas):
        def key(r):
            return (r.tier, _effective_load(r))
        base = sorted(replicas, key=lambda r: (key(r), r.iid))
        with self._lock:
            n = next(self._counter)
        return _rotate_ties(base, key, n)


class EwmaWeighted(Balancer):
    """Rank by expected wait: client-observed EWMA latency × occupancy
    (local in-flight leads, the server's piggybacked load report trails)
    / capacity.  Replicas with no latency sample yet rank *first* (their
    score term is the set's minimum observed EWMA, occupancy-scaled), so
    new/recovered replicas get probed instead of starved."""

    def __init__(self):
        self._counter = itertools.count()  #: guarded-by _lock
        self._lock = threading.Lock()

    def rank(self, replicas):
        if not replicas:
            return []
        sampled = [r.ema_latency for r in replicas if r.ema_latency > 0.0]
        floor = min(sampled) if sampled else 1.0

        def key(r):
            lat = r.ema_latency if r.ema_latency > 0.0 else floor
            occupancy = r.gate.inflight + max(r.load, 0.0) + 1.0
            return lat * occupancy / max(r.capacity, 1)
        base = sorted(replicas, key=lambda r: (key(r), r.iid))
        with self._lock:
            n = next(self._counter)
        return _rotate_ties(base, key, n)


def prefer_instance(ranked: List["Replica"],
                    iid: str | None) -> List["Replica"]:
    """Soft-affinity reorder: move the replica with ``iid`` to the front
    of an already-ranked candidate list, keeping the balancer's order for
    everyone else (they are the fallback path).  A ``iid`` that is not in
    the list — dead, deregistered, or filtered as already-failed — leaves
    the ranking untouched, which is exactly the affinity contract: prefer
    the KV-holding replica, never *depend* on it."""
    if iid is None:
        return ranked
    for i, r in enumerate(ranked):
        if r.iid == iid:
            return [r] + list(ranked[:i]) + list(ranked[i + 1:])
    return ranked


BALANCERS: Dict[str, Type[Balancer]] = {
    "rr": RoundRobin,
    "least": LeastLoaded,
    "locality": LocalityAware,
    "weighted": EwmaWeighted,
}


def make_balancer(spec) -> Balancer:
    if isinstance(spec, Balancer):
        return spec
    cls = BALANCERS.get(spec)
    if cls is None:
        raise ValueError(f"unknown balancer {spec!r}; "
                         f"choose from {sorted(BALANCERS)}")
    return cls()
