"""ServicePool — client-side routed calls to a named service.

The pool resolves a service name through the registry to N live replicas
and routes every call through a pluggable balancer, adding the
reliability layer a single hard-coded URI cannot give:

  * **cached views, refreshed by epoch** — a cheap ``fab.epoch`` poll
    (rate-limited to ``refresh_interval``) detects membership changes;
    the full ``fab.resolve`` only runs on an epoch bump or after a
    failure, so the steady-state per-call overhead is zero RPCs;
  * **locality-tiered resolution** — each replica's address set resolves
    to the cheapest reachable transport (self > sm > tcp, via the same
    tier order as ``na/multi.py``); a tier that fails at runtime (stale
    sm segment after a replica restart) is **demoted** in the cached
    view and the call transparently falls back to the next tier;
  * **deadlines + budgeted retries + hedging** — every call runs under
    :func:`~repro_torch.fabric.policy.call_with_budget`; per-attempt transport
    timeouts are clamped to the caller's deadline, retries use jittered
    exponential backoff and count against a fixed attempt budget which
    *includes* hedge requests, and the losing side of a hedge is
    canceled at the transport;
  * **credit-based flow control** — per-replica credit gates bound
    in-flight requests so a slow replica backpressures instead of
    queueing unboundedly, and gate occupancy feeds back into the
    balancer's load signal.  By default the gates are **adaptive**
    (:class:`~repro_torch.fabric.flow.AdaptiveCreditGate`): each replica's
    limit is grown/shrunk AIMD-style from its observed completion
    latency, so fast replicas absorb more in-flight work and slow ones
    backpressure sooner — ``adaptive_credits=False`` restores the fixed
    ``credits_per_target`` behavior;
  * **deadline-aware admission** — the caller's remaining deadline
    budget rides the request header (``Engine.call_async(deadline=...)``
    → ``RequestHeader.budget_ms``); a server that cannot finish in time
    sheds with ``Ret.OVERLOAD``, which the pool treats as *retry on
    another replica, immediately* (no backoff — see
    ``RetryPolicy.fast_rets``);
  * **replicated control plane** — ``registry_uri`` may name the whole
    registry replica set (list, or one comma-separated string); the
    pool's :class:`~repro_torch.fabric.registry.RegistryClient` sticks to the
    replica that last answered and rotates on dead-peer detection, so a
    registry-leader kill costs at most one failed control-plane RPC —
    never a data-path error (stale cached views keep routing, and the
    post-failover nonce change triggers a full resync).  The plane is
    *unified* (DESIGN.md §8): every quorum node mirrors the instance
    table and the membership table over one delta-gossip stream, so
    follower-served ``fab.resolve`` reads stay within one gossip round
    of the leaseholder even at very large instance counts — the pool's
    steady-state ``fab.epoch`` polls and full resolves are equally
    valid against any replica.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from ..core.executor import CallFuture, Engine, RemoteError
from ..core.na.base import SCHEME_TIERS
from ..core.na.multi import scheme_of as _scheme
from ..core.types import MercuryError, Ret
from ..telemetry import metrics as _metrics
from ..telemetry import trace as _trace
from .balancer import Balancer, make_balancer, prefer_instance
from .flow import AdaptiveCreditGate, CreditGate
from .policy import (BudgetExhausted, DeadlineExceeded, NonRetryable,
                     RetryPolicy, call_with_budget)
from .registry import RegistryClient  # noqa: F401  (re-exported surface)
from .sharding import registry_client_for

# errors worth retrying on another replica: the request may never have
# executed (or the transport lost the answer — or, for OVERLOAD, the
# target refused it untouched because it could not meet the deadline).
# Application faults (FAULT/NOENTRY/INVALID_ARG/...) are NOT retried:
# the handler ran.
_RETRYABLE = {Ret.TIMEOUT, Ret.DISCONNECT, Ret.AGAIN, Ret.NOMEM,
              Ret.CANCELED, Ret.PROTOCOL_ERROR, Ret.CHECKSUM_ERROR,
              Ret.OVERLOAD}
# transport-level failures that indicate the *resolved tier* (not the
# service) is bad — trigger tier demotion and a mark-down
_TIER_FAULTS = {Ret.DISCONNECT, Ret.PROTOCOL_ERROR}
# failures that are congestion signals for the adaptive credit gate: the
# replica (not the transport tier, not the application) is struggling
_CONGESTION = {Ret.TIMEOUT, Ret.AGAIN, Ret.OVERLOAD, Ret.DISCONNECT}

# unified metrics (docs/OPERATIONS.md §7): process-wide totals across
# every pool in this process, exported via fab.metrics
_M_CALLS = _metrics.counter("fabric.pool.calls")
_M_CALL_ERRORS = _metrics.counter("fabric.pool.call_errors")
_M_ATTEMPTS = _metrics.counter("fabric.pool.attempts")
_M_HEDGES = _metrics.counter("fabric.pool.hedges")
_M_CALL_MS = _metrics.histogram("fabric.pool.call_ms")


def _status_of(err: Optional[BaseException]) -> str:
    """Span status string for an attempt/call outcome."""
    if err is None:
        return "OK"
    ret = getattr(err, "ret", None)
    return ret.name if ret is not None else type(err).__name__


class PoolError(MercuryError):
    pass


def _tier_sorted(uris: Sequence[str]) -> List[str]:
    return sorted(uris, key=lambda u: SCHEME_TIERS.get(_scheme(u), 99))


class Replica:
    """The pool's cached view of one service instance: registry-reported
    state + local routing state (resolved tier, credit gate, stats).

    All mutable routing state (``addr``/``resolved_uri``/``bad_schemes``/
    ``down_until``) is guarded by one reentrant lock — ``demote``,
    ``reresolve`` and ``mark_down`` race freely from retry paths on
    different caller threads, and each transition must be atomic."""

    def __init__(self, iid: str, uris: Sequence[str], capacity: int,
                 load: float, gate: CreditGate):
        self.iid = iid
        self.uris = _tier_sorted(uris)
        self.capacity = capacity
        self.load = load
        self.gate = gate
        self.bad_schemes: set = set()  #: guarded-by _lock
        self.addr = None  #: guarded-by _lock
        self.resolved_uri: Optional[str] = None  #: guarded-by _lock
        self.down_until = 0.0  #: guarded-by _lock
        self.calls = 0  #: guarded-by _lock
        self.errors = 0  #: guarded-by _lock
        self.ema_latency = 0.0  #: guarded-by _lock
        # reentrant: demote/reresolve re-enter resolve() under the lock
        self._lock = threading.RLock()

    @property
    def tier(self) -> int:
        with self._lock:
            u = self.resolved_uri
        return SCHEME_TIERS.get(_scheme(u), 99) if u else 99

    def route(self) -> tuple:
        """Consistent (addr, resolved_uri) snapshot — a demote/reresolve
        racing an unlocked pair of reads could hand back the address of
        one tier labelled with the URI of another."""
        with self._lock:
            return self.addr, self.resolved_uri

    def resolve(self, engine: Engine) -> bool:
        """Resolve the cheapest non-demoted tier; False if unreachable."""
        with self._lock:
            for uri in self.uris:
                if _scheme(uri) in self.bad_schemes:
                    continue
                try:
                    self.addr = engine.lookup(uri)
                    self.resolved_uri = uri
                    return True
                except MercuryError:
                    continue
            self.addr = None
            self.resolved_uri = None
            return False

    def demote(self, engine: Engine) -> bool:
        """Demote the currently resolved tier (it failed at runtime) and
        re-resolve; True if a fallback tier exists."""
        with self._lock:
            if self.resolved_uri is None:
                return False
            self.bad_schemes.add(_scheme(self.resolved_uri))
            return self.resolve(engine)

    def reresolve(self, engine: Engine) -> bool:
        """Forget demotions and resolve from scratch — the recovery path
        for transient failures (a blip must not exclude a healthy replica
        forever; a tier that is still broken just demotes again)."""
        with self._lock:
            self.bad_schemes.clear()
            self.down_until = 0.0
            return self.resolve(engine)

    def mark_down(self, ttl: float) -> None:
        with self._lock:
            self.down_until = time.monotonic() + ttl

    @property
    def is_up(self) -> bool:
        with self._lock:
            return (self.addr is not None
                    and time.monotonic() >= self.down_until)

    def record(self, dt: Optional[float], ok: bool) -> None:
        with self._lock:
            self.calls += 1
            if not ok:
                self.errors += 1
            elif dt is not None:
                self.ema_latency = (0.2 * dt + 0.8 * self.ema_latency
                                    if self.ema_latency else dt)
        # feed the adaptive credit controller outside the routing lock
        # (the gate has its own lock; no nesting, no ordering constraint)
        if ok and dt is not None and isinstance(self.gate,
                                                AdaptiveCreditGate):
            self.gate.record_latency(dt)

    def penalize(self) -> None:
        """A congestion-class failure: multiplicative-decrease the
        adaptive gate (no-op on fixed gates)."""
        if isinstance(self.gate, AdaptiveCreditGate):
            self.gate.record_failure()

    def stat(self) -> dict:
        with self._lock:
            return {"iid": self.iid, "uri": self.resolved_uri,
                    "tier": _scheme(self.resolved_uri or "?"),
                    "capacity": self.capacity, "load": self.load,
                    "calls": self.calls, "errors": self.errors,
                    "ema_latency_ms": self.ema_latency * 1e3,
                    "up": self.is_up, **self.gate.stats()}


class ServicePool:
    """Resolve ``service`` via the registry and route calls across its
    replicas.  Thread-safe: many caller threads may ``call`` at once."""

    def __init__(self, engine: Engine, registry_uri, service: str,
                 balancer: Balancer | str = "locality",
                 policy: Optional[RetryPolicy] = None,
                 credits_per_target: int = 8,
                 adaptive_credits: bool = True,
                 credit_min: int = 1, credit_max: int = 64,
                 credit_target_latency: Optional[float] = None,
                 refresh_interval: float = 0.25,
                 load_refresh_interval: float = 1.0,
                 default_timeout: float = 30.0,
                 down_ttl: float = 2.0,
                 cache_ttl: Optional[float] = None):
        self.engine = engine
        self.service = service
        # short control-plane timeout: a dead registry must not stall the
        # data path (stale cached views keep routing).  registry_uri may
        # be the whole replica set; the client fails over between them.
        # The client-side read cache (DESIGN.md §9) collapses concurrent
        # refresh storms — hedged attempts and many caller threads all
        # force-refreshing at once singleflight into one fab.resolve —
        # and its TTL (default: half the refresh interval, so it never
        # adds more than one poll period of staleness) soaks up repeat
        # polls between ticks.  Correctness does not rest on the TTL:
        # every epoch bump or nonce change the client observes evicts.
        if cache_ttl is None:
            cache_ttl = refresh_interval / 2
        # A sharded spec ('|'-separated shard quorums, DESIGN.md §12)
        # binds the pool to the one shard that owns this service name —
        # the epoch-poll/token refresh below is per-shard by design.
        self.registry = registry_client_for(engine, registry_uri,
                                            service=service, timeout=2.0,
                                            cache_ttl=cache_ttl)
        self.balancer = make_balancer(balancer)
        self.policy = policy or RetryPolicy()
        self.credits_per_target = credits_per_target
        self.adaptive_credits = adaptive_credits
        self.credit_min = credit_min
        self.credit_max = credit_max
        self.credit_target_latency = credit_target_latency
        self.refresh_interval = refresh_interval
        # piggybacked load/capacity reports do not bump the epoch, so a
        # pure epoch poll would freeze them between membership changes;
        # do a full resolve at least this often for the load-aware
        # balancers (least / weighted)
        self.load_refresh_interval = load_refresh_interval
        self.default_timeout = default_timeout
        self.down_ttl = down_ttl
        self._view: Dict[str, Replica] = {}  #: guarded-by _view_lock
        self._view_epoch = -1  #: guarded-by _view_lock
        self._view_nonce: Optional[str] = None  #: guarded-by _view_lock
        self._next_epoch_check = 0.0  #: guarded-by _view_lock
        self._next_load_refresh = 0.0  #: guarded-by _view_lock
        self._view_lock = threading.Lock()
        self.refresh(force=True)

    def _make_gate(self) -> CreditGate:
        if not self.adaptive_credits:
            return CreditGate(self.credits_per_target)
        return AdaptiveCreditGate(
            self.credits_per_target, min_credits=self.credit_min,
            max_credits=self.credit_max,
            target_latency=self.credit_target_latency)

    # -- view management -----------------------------------------------------
    def refresh(self, force: bool = False) -> None:
        """Bring the cached replica view up to date.  Rate-limited epoch
        poll unless ``force``; full resolve when the epoch moved, the
        registry's nonce changed (restart), or piggybacked load is due."""
        now = time.monotonic()
        with self._view_lock:
            if not force and now < self._next_epoch_check:
                return
            self._next_epoch_check = now + self.refresh_interval
            load_due = now >= self._next_load_refresh
            have_epoch, have_nonce = self._view_epoch, self._view_nonce
        try:
            if not force and not load_due:
                # cheap poll first; resolve only when something moved
                epoch, nonce = self.registry.epoch_info()
                if epoch == have_epoch and nonce == have_nonce:
                    return
            # forced refreshes (retry/failover paths) must see the
            # authority — bypass the read cache but still singleflight
            view = self.registry.resolve(self.service,
                                         fresh=force or load_due)
        except MercuryError:
            return                        # registry briefly unreachable
        with self._view_lock:
            nonce = view.get("nonce")
            if nonce == self._view_nonce and view["epoch"] < self._view_epoch:
                # raced a newer refresh *of the same registry run*: keep
                # it.  A different nonce means the registry restarted and
                # reset its epoch — that view is fresher, never stale.
                return
            self._next_load_refresh = (time.monotonic()
                                       + self.load_refresh_interval)
            fresh: Dict[str, Replica] = {}
            for inst in view["instances"]:
                old = self._view.get(inst["iid"])
                if old is not None:
                    # keep gate/stats/demotions; update reported state
                    old.capacity = inst["capacity"]
                    old.load = inst["load"]
                    new_uris = _tier_sorted(inst["uris"])
                    if new_uris != old.uris:
                        # instance re-registered on new addresses (e.g.
                        # restarted on another port): demotions are stale
                        old.uris = new_uris
                        old.reresolve(self.engine)
                    fresh[inst["iid"]] = old
                else:
                    rep = Replica(inst["iid"], inst["uris"],
                                  inst["capacity"], inst["load"],
                                  self._make_gate())
                    rep.resolve(self.engine)
                    fresh[inst["iid"]] = rep
            self._view = fresh
            self._view_epoch = view["epoch"]
            self._view_nonce = nonce
        # unreachable-at-creation replicas get another chance each refresh
        for rep in fresh.values():
            if rep.route()[0] is None:
                rep.reresolve(self.engine)

    @property
    def epoch(self) -> int:
        with self._view_lock:
            return self._view_epoch

    def replicas(self) -> List[Replica]:
        with self._view_lock:
            return list(self._view.values())

    # -- call path -----------------------------------------------------------
    def call(self, rpc: str, arg: Any = None,
             timeout: Optional[float] = None,
             deadline: Optional[float] = None,
             policy: Optional[RetryPolicy] = None) -> Any:
        """Routed, deadline-bounded, retried (and optionally hedged) call.

        ``timeout`` is relative, ``deadline`` absolute (``monotonic``);
        deadline wins if both are given.
        """
        return self._call(rpc, arg, timeout, deadline, policy, None)[0]

    def call_routed(self, rpc: str, arg: Any = None,
                    timeout: Optional[float] = None,
                    deadline: Optional[float] = None,
                    policy: Optional[RetryPolicy] = None,
                    prefer: Optional[str] = None) -> tuple:
        """Like :meth:`call` but returns ``(value, iid)`` — the instance
        that actually served the request.  Use with :meth:`call_on` for
        replica-affine protocols (``gen.submit``'s rid only exists on the
        replica that admitted it).

        ``prefer`` is *soft* affinity: route to that instance first if it
        is live, but fall back to the normal balancer ranking when it is
        down, gone from the view, or has already failed this call — the
        session-affinity layer uses this so a dead KV-holding replica
        degrades to a fresh-prefill route instead of an error (contrast
        :meth:`call_on`, which is a hard pin)."""
        return self._call(rpc, arg, timeout, deadline, policy, None,
                          prefer=prefer)

    def call_on(self, iid: str, rpc: str, arg: Any = None,
                timeout: Optional[float] = None,
                deadline: Optional[float] = None,
                policy: Optional[RetryPolicy] = None) -> Any:
        """Pinned call: route only to instance ``iid`` (deadline/retry
        budget still applies; no hedging to other replicas).  If the
        instance left the view, the budget fails with
        ``BudgetExhausted`` whose cause is ``PoolError(NOENTRY)`` —
        retried rather than failed fast because a restarting instance
        re-registers under its old iid."""
        return self._call(rpc, arg, timeout, deadline, policy, iid)[0]

    def _call(self, rpc: str, arg: Any, timeout: Optional[float],
              deadline: Optional[float], policy: Optional[RetryPolicy],
              only_iid: Optional[str],
              prefer: Optional[str] = None) -> tuple:
        policy = policy or self.policy
        if deadline is None:
            deadline = time.monotonic() + (timeout if timeout is not None
                                           else self.default_timeout)
        # one logical call = one trace: root a new one here (head-sampled)
        # unless the caller is already inside a traced request, in which
        # case the pool call is a child span of it
        parent = _trace.current()
        root = (_trace.start_span(f"pool.{self.service}.{rpc}", parent)
                if parent is not None
                else _trace.start_trace(f"pool.{self.service}.{rpc}"))
        state = {"issued": 0, "failed_iids": set(), "winner": None,
                 "tctx": root.ctx}

        def attempt(idx: int, attempt_timeout: float) -> Any:
            if state["issued"] >= policy.attempts:
                # hedges consumed the remaining budget
                raise NonRetryable(BudgetExhausted(
                    f"{self.service}.{rpc}: attempt budget "
                    f"({policy.attempts}) consumed by hedged requests"))
            if idx > 0:
                self.refresh(force=True)   # pick up epoch bumps fast
            else:
                self.refresh()
            return self._attempt_once(rpc, arg, attempt_timeout, policy,
                                      state, deadline, only_iid,
                                      prefer=prefer)

        t0 = time.monotonic()
        _M_CALLS.inc()
        try:
            result = call_with_budget(policy, deadline, attempt)
        except BaseException as e:
            _M_CALL_ERRORS.inc()
            root.finish(_status_of(e), attempts=state["issued"])
            raise
        _M_CALL_MS.observe((time.monotonic() - t0) * 1e3)
        root.finish("OK", attempts=state["issued"], winner=state["winner"])
        return result, state["winner"]

    def _candidates(self, failed: set,
                    only_iid: Optional[str] = None,
                    prefer: Optional[str] = None) -> List[Replica]:
        reps = self.replicas()
        if only_iid is not None:
            reps = [r for r in reps if r.iid == only_iid]
        ranked = self.balancer.rank([r for r in reps if r.is_up])
        if not ranked and reps:
            # nobody is up: recover from (possibly stale) demotions and
            # mark-downs before declaring the service unreachable
            ranked = self.balancer.rank(
                [r for r in reps if r.reresolve(self.engine)])
        pref = [r for r in ranked if r.iid not in failed]
        # soft affinity last: a preferred iid that is down, gone, or in
        # ``failed`` never survives the filters above, so the fallback to
        # plain balancer order is automatic
        return prefer_instance(pref or ranked, prefer)

    def _attempt_once(self, rpc: str, arg: Any, attempt_timeout: float,
                      policy: RetryPolicy, state: dict, deadline: float,
                      only_iid: Optional[str] = None,
                      prefer: Optional[str] = None) -> Any:
        t_start = time.monotonic()
        # re-clamp to the caller's absolute deadline: the view refresh
        # that ran before this attempt burned real time after
        # attempt_timeout was computed
        attempt_deadline = min(t_start + attempt_timeout, deadline)
        candidates = self._candidates(state["failed_iids"], only_iid,
                                      prefer=prefer)
        if not candidates:
            raise PoolError(Ret.NOENTRY,
                            f"no live replicas for {self.service!r}"
                            + (f" (pinned to {only_iid})" if only_iid
                               else ""))

        t_adm = time.monotonic()
        primary = self._admit(candidates, attempt_deadline)
        admit_ms = (time.monotonic() - t_adm) * 1e3
        futs: List[CallFuture] = []
        owners: List[Replica] = []
        try:
            try:
                futs.append(self._issue(primary, rpc, arg, attempt_deadline,
                                        state, admit_ms=admit_ms))
            except MercuryError as e:
                # sync failure (e.g. un-encodable arg -> INVALID_ARG) gets
                # the same retryable/non-retryable classification as
                # errors delivered through futures
                self._note_failure(primary, e, state)
                self._raise_attempt_error(e)
            owners.append(primary)
            return self._await(futs, owners, rpc, arg, candidates, policy,
                               state, attempt_deadline, t_start)
        finally:
            for f in futs:
                if not f.done():
                    f.cancel_call()

    def _admit(self, candidates: List[Replica], attempt_deadline: float
               ) -> Replica:
        """Find a replica with a free credit; if everyone is saturated,
        wait (bounded) on the best-ranked gate — that wait *is* the
        backpressure the flow control is for."""
        for rep in candidates:
            if rep.gate.try_acquire():
                return rep
        best = candidates[0]
        wait = max(attempt_deadline - time.monotonic(), 0.0)
        if not best.gate.acquire(wait):
            raise PoolError(Ret.AGAIN,
                            f"{self.service}: all replicas saturated "
                            f"({best.gate.credits} credits each)")
        return best

    def _issue(self, rep: Replica, rpc: str, arg: Any,
               attempt_deadline: float, state: dict,
               admit_ms: float = 0.0, hedge: bool = False) -> CallFuture:
        """One wire RPC to one replica (credit already held); the credit
        is returned when the future settles, whatever settles it.

        Each issue is a child span of the call's trace, tagged with the
        replica it targeted, its credit-gate admission wait, and — when
        the future settles — its outcome (a hedge loser closes
        ``CANCELED``).  The span context is ambient around
        ``call_async`` so it rides the wire and the replica's server
        span becomes its child."""
        state["issued"] += 1
        _M_ATTEMPTS.inc()
        if hedge:
            _M_HEDGES.inc()
        addr, uri = rep.route()
        span = _trace.start_span(f"attempt.{rpc}", state.get("tctx"))
        if span.recorded:
            span.annotate(iid=rep.iid, uri=uri or "?",
                          n=state["issued"], hedge=hedge,
                          admit_ms=round(admit_ms, 3))
        try:
            with _trace.use(span.ctx):
                fut = self.engine.call_async(addr, rpc, arg,
                                             deadline=attempt_deadline)
        except BaseException as e:
            rep.gate.release()        # sync failure (e.g. MSGSIZE)
            span.finish(_status_of(e))
            raise
        # latency samples must start at ISSUE time: measuring from the
        # attempt start would fold our own credit-gate wait (and the
        # hedge delay) into the replica's latency, and the adaptive gate
        # would misread its own backpressure as server congestion — a
        # positive-feedback collapse of the limit
        fut.issued_at = time.monotonic()

        def _settled(f: CallFuture) -> None:
            rep.gate.release()
            span.finish(_status_of(f.exception()))

        fut.add_done_callback(_settled)
        return fut

    def _await(self, futs: List[CallFuture], owners: List[Replica],
               rpc: str, arg: Any, candidates: List[Replica],
               policy: RetryPolicy, state: dict, attempt_deadline: float,
               t_start: float) -> Any:
        """Wait for the attempt's future(s); launch a hedge once the
        hedge delay passes; first success wins and the loser is canceled."""
        hedged = False
        pending = list(futs)
        while True:
            now = time.monotonic()
            remaining = attempt_deadline - now
            if remaining <= 0 and pending:
                # this wall-clock check usually beats the transport's own
                # deadline timer: the hung replicas must still take the
                # TIMEOUT congestion penalty and attempt-level exclusion
                err = RemoteError(Ret.TIMEOUT, f"{rpc}: attempt timed out")
                for f in pending:
                    self._note_failure(owners[futs.index(f)], err, state)
                raise err
            wait_for = remaining
            if (not hedged and policy.hedge_after is not None
                    and state["issued"] < policy.attempts):
                wait_for = min(wait_for,
                               max(t_start + policy.hedge_after - now, 0.0))
            done, not_done = cf.wait(pending, timeout=max(wait_for, 0.0),
                                     return_when=cf.FIRST_COMPLETED)
            for f in done:
                pending.remove(f)
                rep = owners[futs.index(f)]
                err = f.exception()
                if err is None:
                    rep.record(time.monotonic() - f.issued_at, ok=True)
                    state["winner"] = rep.iid
                    return f.result()
                self._note_failure(rep, err, state)
            if not pending and done:
                # every issued future failed: surface the last error to
                # the budget loop (retryable or not decided there)
                self._raise_attempt_error(err)
            if (not hedged and policy.hedge_after is not None
                    and time.monotonic() - t_start >= policy.hedge_after
                    and state["issued"] < policy.attempts):
                hedged = True
                hedge_rep = self._hedge_candidate(candidates, owners)
                if hedge_rep is not None:
                    futs.append(self._issue(hedge_rep, rpc, arg,
                                            attempt_deadline, state,
                                            hedge=True))
                    owners.append(hedge_rep)
                    pending.append(futs[-1])
            if not pending:
                raise RemoteError(Ret.TIMEOUT, f"{rpc}: attempt timed out")

    def _hedge_candidate(self, candidates: List[Replica],
                         owners: List[Replica]) -> Optional[Replica]:
        for rep in candidates:
            if rep not in owners and rep.gate.try_acquire():
                return rep
        return None

    def _note_failure(self, rep: Replica, err: BaseException,
                      state: dict) -> None:
        rep.record(None, ok=False)
        state["failed_iids"].add(rep.iid)
        ret = getattr(err, "ret", None)
        if ret in _CONGESTION:
            rep.penalize()                # adaptive gate: shrink the limit
        if ret in _TIER_FAULTS:
            # the resolved tier is broken (e.g. stale sm segment after a
            # replica restart): demote it; no fallback tier -> mark down
            if not rep.demote(self.engine):
                rep.mark_down(self.down_ttl)
        elif ret is not None and ret not in _RETRYABLE:
            pass                          # application error: replica fine

    @staticmethod
    def _raise_attempt_error(err: BaseException) -> None:
        ret = getattr(err, "ret", None)
        if ret is not None and ret not in _RETRYABLE:
            raise NonRetryable(err)
        raise err

    # -- conveniences --------------------------------------------------------
    def call_each(self, rpc: str, arg: Any = None,
                  timeout: Optional[float] = None) -> Dict[str, Any]:
        """Call every live replica once (admin/broadcast helper); returns
        {iid: result-or-exception}."""
        out: Dict[str, Any] = {}
        for rep in self.replicas():
            if not rep.is_up:
                continue
            try:
                out[rep.iid] = self.engine.call(
                    rep.route()[0], rpc, arg,
                    timeout=timeout or self.default_timeout)
            except Exception as e:        # noqa: BLE001 — broadcast survey
                out[rep.iid] = e
        return out

    def stats(self) -> dict:
        return {"service": self.service, "epoch": self.epoch,
                "balancer": self.balancer.name,
                "replicas": [r.stat() for r in self.replicas()]}

    def close(self) -> None:
        """The pool owns no threads; kept for symmetry with servers."""
