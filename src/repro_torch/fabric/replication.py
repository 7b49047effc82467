"""Replication machinery for the fabric's control plane.

The replicated control plane (DESIGN.md §8) runs N engines over a
**static, ordered peer list** shared by every node — list order *is*
leadership priority.  PR 4 built the protocol for the registry's
instance table; this module is the table-agnostic extraction, so the
registry's instance table and the membership service's member table are
now just two :class:`ReplicatedTable` instances hosted by one
:class:`ReplicationCore` per node:

  * :class:`PeerTracker` — deterministic leader-lease state.  A peer is
    *live* while it was heard from within ``lease_ttl`` seconds; the
    leader is the live peer with the lowest rank.  Liveness starts
    optimistic (every peer is assumed alive at boot) so a restarting
    replica never steals leadership before the incumbent's lease had a
    chance to renew, and a **boot grace** window defers self-election
    until the newcomer has either adopted a snapshot from an acting
    leader or waited a full lease out — a restarted rank-0 replica
    therefore *resyncs before it leads* instead of resurrecting with an
    empty table.
  * :class:`ReplicatedTable` — one named, versioned ``key -> record``
    table.  Every membership-meaningful mutation (put/delete/expiry)
    stamps the entry with the table's next **version** (the version
    counter *is* the table epoch), and deletions leave tombstones so a
    leader can ship **deltas**: only the entries whose version exceeds
    what a peer last acknowledged.  Load/liveness updates are *soft*
    state: they bump no version (no client resolve storms, no delta
    churn) and ride gossip only when a value actually changed.
  * :class:`ReplicationCore` — hosts the tables on one engine and keeps
    them replicated: leader lease (via the tracker), delta gossip with
    automatic full-snapshot fallback, one-hop write proxying, takeover
    (fresh nonce + liveness refresh so failover never mass-expires),
    and the single TTL sweeper that expires stale entries *on the
    leaseholder only* and fires each table's expiry hooks there.
    With ``peers=None`` the core degrades to a single-node control
    plane: always leading, no gossip thread, same table API.
  * :class:`QuorumCaller` — client-side sticky failover over a
    control-plane *address set* (one endpoint per replica), shared by
    :class:`~repro_torch.fabric.registry.RegistryClient` and
    :class:`~repro_torch.services.membership.MembershipClient`.
  * :func:`parse_registry_uris` — the address-set parser (one endpoint
    per replica, comma-separated; each endpoint may itself be a
    ``;``-joined multi-transport address set, see DESIGN.md §2).

The wire half (``fab.*`` / ``mem.*`` request schemas) lives with the
services that own each table (:mod:`repro_torch.fabric.registry`,
:mod:`repro_torch.services.membership`); the shared ``fab.gossip`` stream is
driven entirely by the core.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core import proc as hg_proc
from ..core.types import MercuryError, Ret
from ..telemetry import trace as _trace

# transport-class failures that mean "this control-plane endpoint (or
# the proxy path behind it) is unreachable/unsettled — try another
# replica"; application errors (NOENTRY from fab.report, INVALID_ARG,
# ...) must pass through: the handler ran.
FAILOVER_RETS = {Ret.TIMEOUT, Ret.DISCONNECT, Ret.AGAIN, Ret.CANCELED,
                 Ret.PROTOCOL_ERROR}


def parse_registry_uris(spec) -> List[str]:
    """Parse a control-plane address set: a sequence of endpoint URIs,
    or one comma-separated string (``"tcp://a:7700,tcp://b:7700"``).
    Each endpoint may itself be a ``;``-joined multi-transport address
    set.

    >>> parse_registry_uris("tcp://a:7700, tcp://b:7700")
    ['tcp://a:7700', 'tcp://b:7700']
    >>> parse_registry_uris(["sm://reg0;tcp://a:7700"])
    ['sm://reg0;tcp://a:7700']
    """
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",")]
    else:
        parts = [str(p).strip() for p in spec]
    uris = [p for p in parts if p]
    if not uris:
        raise ValueError(f"empty registry address set: {spec!r}")
    return uris


class PeerTracker:
    """Deterministic leader-lease state over a static ordered peer list.

    Thread-safe; all times come from the injected ``clock`` (monotonic)
    so tests can drive the lease deterministically.
    """

    def __init__(self, peers: Sequence[str], self_uri: str,
                 lease_ttl: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        peers = list(peers)
        if self_uri not in peers:
            raise ValueError(f"self_uri {self_uri!r} is not in the peer "
                             f"list {peers!r} — every replica must be "
                             f"started with the same ordered --peers list "
                             f"and its own entry as --listen/--self")
        if len(set(peers)) != len(peers):
            raise ValueError(f"duplicate entries in peer list {peers!r}")
        self.peers = peers
        self.self_uri = self_uri
        self.rank: Dict[str, int] = {u: i for i, u in enumerate(peers)}
        self.lease_ttl = lease_ttl
        self._clock = clock
        now = clock()
        # optimistic start: assume everyone is alive until a full lease
        # passes without contact (prevents takeover storms at boot)
        self._last_heard: Dict[str, float] = {
            u: now for u in peers if u != self_uri}  #: guarded-by _lock
        # boot grace: do not self-elect until we either adopted a
        # snapshot from an acting leader or waited one lease out
        self._boot_until = now + lease_ttl  #: guarded-by _lock
        self._synced = False  #: guarded-by _lock
        self._lock = threading.Lock()

    # -- liveness ------------------------------------------------------------
    def note(self, uri: str) -> None:
        """Record contact with ``uri`` (either direction of gossip)."""
        with self._lock:
            if uri in self._last_heard:
                self._last_heard[uri] = self._clock()

    def mark_synced(self) -> None:
        """We adopted an acting leader's snapshot: boot grace is over."""
        with self._lock:
            self._synced = True

    def in_grace(self) -> bool:
        with self._lock:
            return not self._synced and self._clock() < self._boot_until

    def is_alive(self, uri: str) -> bool:
        """Lease check for one peer (self is always alive)."""
        with self._lock:
            if uri not in self._last_heard:
                return uri == self.self_uri
            return self._clock() - self._last_heard[uri] <= self.lease_ttl

    def others(self) -> List[str]:
        return [u for u in self.peers if u != self.self_uri]

    # -- leadership ----------------------------------------------------------
    def leader_uri(self):
        """The current leaseholder: the lowest-rank live peer.  ``None``
        while we are still in boot grace and every lower-rank peer looks
        dead (leadership is unknowable until the grace resolves)."""
        now = self._clock()
        grace = self.in_grace()
        with self._lock:
            for uri in self.peers:
                if uri == self.self_uri:
                    if grace:
                        continue          # defer: an acting leader may exist
                    return uri
                if now - self._last_heard[uri] <= self.lease_ttl:
                    return uri
            return None if grace else self.self_uri

    def peer_stats(self) -> List[dict]:
        now = self._clock()
        with self._lock:
            out = []
            for uri in self.peers:
                if uri == self.self_uri:
                    out.append({"uri": uri, "self": True, "alive": True,
                                "age_s": 0.0})
                else:
                    age = now - self._last_heard[uri]
                    out.append({"uri": uri, "self": False,
                                "alive": age <= self.lease_ttl,
                                "age_s": round(age, 3)})
            return out


class ReplicatedTable:
    """One replicated ``key -> record`` table (DESIGN.md §8).

    Records are plain dicts; the table owns one bookkeeping field,
    ``last`` (monotonic stamp of the last liveness touch — shipped as
    ``age`` on the wire so mirrored stamps survive clock domains).

    **Version stamps**: the table epoch is a per-table version counter.
    ``put``/``delete`` (and TTL expiry) assign the entry the next
    version; a leader can therefore answer "what changed since version
    v" exactly — the **delta** — as long as every deletion with version
    > v is still held as a tombstone.  Tombstones are garbage-collected
    after ``tombstone_ttl``; the *horizon* records the newest GC'd
    deletion, and a delta request from before the horizon returns
    ``None`` — the caller must fall back to a full snapshot.

    ``update`` is the *soft* path: load/liveness refreshes that must
    not bump the epoch (clients would resolve-storm) and must not
    create delta traffic unless a value actually changed.

    Mutators are leader-only by contract; followers converge via
    :meth:`install` (snapshot) and :meth:`apply_delta`, both driven by
    the :class:`ReplicationCore` gossip.  All methods take the lock the
    core shared at construction (reentrant — handlers may compose
    read-modify-write sequences under the same lock).
    """

    def __init__(self, name: str, lock: threading.RLock,
                 ttl: Optional[float] = None, tombstone_ttl: float = 30.0,
                 dirty_cb: Optional[Callable[[], None]] = None):
        self.name = name
        self._lock = lock
        self.ttl = ttl
        self.tombstone_ttl = tombstone_ttl
        self._dirty_cb = dirty_cb or (lambda: None)
        self.entries: Dict[str, dict] = {}  #: guarded-by _lock
        self.vers: Dict[str, int] = {}  #: guarded-by _lock
        self.epoch = 0  #: guarded-by _lock  (version counter)
        self._tombs: Dict[str, Tuple[int, float]] = {}  #: guarded-by _lock
        self._horizon = 0  #: guarded-by _lock  (newest GC'd deletion ver)
        self._soft_dirty: set = set()  #: guarded-by _lock
        self._expire_cbs: List[Callable[[List[str]], None]] = []

    # -- reads ---------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self.entries)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            return self.entries.get(key)

    def items(self) -> List[Tuple[str, dict]]:
        with self._lock:
            return list(self.entries.items())

    # -- leader-side mutators ------------------------------------------------
    def put(self, key: str, rec: dict) -> int:
        """Versioned write: (re)place ``rec`` under ``key`` and stamp it
        with the next version.  Returns the new epoch."""
        with self._lock:
            rec = dict(rec)
            rec.setdefault("last", time.monotonic())
            self.epoch += 1
            self.entries[key] = rec
            self.vers[key] = self.epoch
            self._tombs.pop(key, None)
            self._soft_dirty.discard(key)
            self._dirty_cb()
            return self.epoch

    def update(self, key: str, **fields) -> bool:
        """Soft write: refresh liveness and update ``fields`` in place
        with *no* version bump.  Marks the entry delta-dirty only when a
        value actually changed (idle heartbeats cost zero gossip bytes).
        False if the key is unknown (expired: caller should re-put)."""
        with self._lock:
            rec = self.entries.get(key)
            if rec is None:
                return False
            rec["last"] = time.monotonic()
            changed = any(rec.get(f) != v for f, v in fields.items())
            rec.update(fields)
            if changed:
                self._soft_dirty.add(key)
            return True

    def delete(self, key: str) -> bool:
        """Versioned delete: tombstoned so deltas can replicate it."""
        with self._lock:
            if key not in self.entries:
                return False
            del self.entries[key]
            self.vers.pop(key, None)
            self.epoch += 1
            self._tombs[key] = (self.epoch,
                                time.monotonic() + self.tombstone_ttl)
            self._soft_dirty.discard(key)
            self._dirty_cb()
            return True

    def expire(self, now: float) -> List[str]:
        """Delete every entry whose liveness stamp is older than
        ``ttl``; returns the expired keys (leader's sweeper only)."""
        with self._lock:
            if self.ttl is None:
                return []
            dead = [k for k, v in self.entries.items()
                    if now - v["last"] > self.ttl]
            for k in dead:
                del self.entries[k]
                self.vers.pop(k, None)
                self.epoch += 1
                self._tombs[k] = (self.epoch,
                                  time.monotonic() + self.tombstone_ttl)
                self._soft_dirty.discard(k)
            if dead:
                self._dirty_cb()
            return dead

    def refresh_liveness(self, now: float) -> None:
        """Stamp every entry live *now* — the takeover rule: entries
        that could not heartbeat while the old leader was dying must
        not be mass-expired the moment the lease moves."""
        with self._lock:
            for rec in self.entries.values():
                rec["last"] = now

    def bump(self) -> int:
        """Advance the epoch without touching entries (takeover marker:
        pools watching the epoch see the stream move)."""
        with self._lock:
            self.epoch += 1
            return self.epoch

    # -- expiry hooks --------------------------------------------------------
    def on_expire(self, cb: Callable[[List[str]], None]) -> None:
        """Register ``cb(expired_keys)``; the core fires it (outside the
        lock, leaseholder only) after a sweep or an explicit delete."""
        self._expire_cbs.append(cb)

    def fire_expired(self, keys: List[str]) -> None:
        for cb in self._expire_cbs:
            try:
                cb(keys)
            except Exception:
                pass                      # hooks must not kill the sweeper

    # -- wire ----------------------------------------------------------------
    @staticmethod
    def _wire_rec(rec: dict, now: float) -> dict:
        out = {k: v for k, v in rec.items() if k != "last"}
        out["age"] = round(now - rec.get("last", now), 3)
        return out

    @staticmethod
    def _unwire_rec(rec: dict, now: float) -> dict:
        out = {k: v for k, v in rec.items() if k != "age"}
        out["last"] = now - float(rec.get("age", 0.0))
        return out

    def snapshot(self, now: float) -> dict:
        with self._lock:
            return {"epoch": self.epoch,
                    "entries": [{"k": k, "ver": self.vers[k],
                                 "rec": self._wire_rec(v, now)}
                                for k, v in self.entries.items()]}

    def install(self, snap: dict, now: float) -> None:
        """Full-state overwrite from a snapshot (follower resync)."""
        with self._lock:
            self.entries = {e["k"]: self._unwire_rec(e["rec"], now)
                            for e in snap["entries"]}
            self.vers = {e["k"]: int(e["ver"]) for e in snap["entries"]}
            self.epoch = int(snap["epoch"])
            self._tombs.clear()
            # a freshly installed mirror has no deletion history: it can
            # only produce deltas for peers at or past this epoch
            self._horizon = self.epoch
            self._soft_dirty.clear()

    #: requires _lock
    def _gc_tombs(self, now: float) -> None:
        dead = [k for k, (_, drop) in self._tombs.items() if drop <= now]
        for k in dead:
            ver, _ = self._tombs.pop(k)
            self._horizon = max(self._horizon, ver)

    def delta_since(self, base: int, now: float) -> Optional[dict]:
        """Changes with version > ``base``; ``None`` when ``base`` is
        behind the tombstone horizon (or ahead of us) — the caller must
        send a full snapshot instead."""
        with self._lock:
            self._gc_tombs(now)
            if base < self._horizon or base > self.epoch:
                return None
            return {
                "base": base, "epoch": self.epoch,
                "put": [{"k": k, "ver": self.vers[k],
                         "rec": self._wire_rec(self.entries[k], now)}
                        for k in self.entries if self.vers[k] > base],
                "del": [[k, ver] for k, (ver, _) in self._tombs.items()
                        if ver > base],
            }

    def take_soft(self, now: float) -> List[dict]:
        """Drain the soft-dirty set as wire records (coalesced: one
        entry per key however many heartbeats touched it this round)."""
        with self._lock:
            out = [{"k": k, "rec": self._wire_rec(self.entries[k], now)}
                   for k in self._soft_dirty if k in self.entries]
            self._soft_dirty.clear()
            return out

    def apply_delta(self, delta: dict, now: float) -> bool:
        """Apply a leader's delta to this mirror.  False when the delta
        does not connect to our state (its base is past our epoch —
        we missed deletions in between): the caller's next heartbeat
        advertises our epoch and the leader answers with a snapshot."""
        with self._lock:
            if int(delta["base"]) > self.epoch:
                return False
            for e in delta.get("put", ()):
                ver = int(e["ver"])
                if self.vers.get(e["k"], 0) < ver:
                    self.entries[e["k"]] = self._unwire_rec(e["rec"], now)
                    self.vers[e["k"]] = ver
            for k, ver in delta.get("del", ()):
                if self.vers.get(k, 0) <= int(ver):
                    self.entries.pop(k, None)
                    self.vers.pop(k, None)
            self.epoch = max(self.epoch, int(delta["epoch"]))
            return True

    def apply_soft(self, soft: List[dict], now: float) -> None:
        """Merge soft (load/liveness) records into the mirror; unknown
        keys are skipped (the versioned stream owns membership)."""
        with self._lock:
            for e in soft:
                if e["k"] in self.entries:
                    self.entries[e["k"]] = self._unwire_rec(e["rec"], now)

    def status(self) -> dict:
        with self._lock:
            return {"epoch": self.epoch, "entries": len(self.entries),
                    "tombstones": len(self._tombs),
                    "horizon": self._horizon}


def _payload_bytes(payload: dict) -> int:
    """Wire size of a gossip payload (the same proc the RPC layer
    uses) — feeds the delta-vs-snapshot byte counters in fab.status and
    the ``gossip_churn`` benchmark."""
    try:
        return len(hg_proc.encode(hg_proc.proc_any, payload))
    except Exception:
        return 0


class ReplicationCore:
    """Hosts named :class:`ReplicatedTable`\\ s on one engine and keeps
    them replicated across a static quorum (DESIGN.md §8).

    One core per node carries *all* control-plane tables — the registry
    instance table and the membership member table share one leader
    lease, one gossip stream (``fab.gossip``), one nonce, and one TTL
    sweeper.  With ``peers=None`` the core is a single-node control
    plane: always leading, no gossip, same API.

    **Delta gossip** (default): the leader tracks, per peer, the last
    acknowledged ``(nonce, per-table epoch)`` — acks arrive both as
    responses to its pushes and as the followers' own heartbeats — and
    pushes only entries versioned past the ack, plus coalesced soft
    (load/liveness) records that actually changed.  A peer whose ack is
    missing, carries a different nonce, or falls behind a table's
    tombstone horizon is resynced with a **full snapshot** instead
    (rate-limited per peer so a dead peer does not cost a snapshot
    encode per tick).  ``delta_gossip=False`` restores the PR-4
    full-state protocol (snapshot on membership change + periodic
    cadence) — kept as the comparison baseline for the
    ``gossip_churn`` benchmark and as an operational escape hatch.
    """

    def __init__(self, engine, peers: Optional[Sequence[str]] = None,
                 self_uri: Optional[str] = None, lease_ttl: float = 1.0,
                 gossip_interval: float = 0.25,
                 sweep_interval: float = 0.5,
                 rpc_name: str = "fab.gossip",
                 delta_gossip: bool = True,
                 tombstone_ttl: Optional[float] = None,
                 autostart: bool = True):
        self.engine = engine
        self.rpc_name = rpc_name
        self.delta_gossip = delta_gossip
        self.gossip_interval = gossip_interval
        self._lock = threading.RLock()
        self.tables: Dict[str, ReplicatedTable] = {}  #: guarded-by _lock
        # stream nonce: epochs are only comparable within one nonce (a
        # restarted node restarts at epoch 0 and a failed-over leader
        # starts a fresh stream — see DESIGN.md §8)
        self.nonce = uuid.uuid4().hex[:12]  #: guarded-by _lock
        self._stop = threading.Event()
        self._dirty = threading.Event()   # membership moved: push now
        self._tick_hooks: List[Callable[[], None]] = []
        # per-peer replication ack: peer -> {"nonce", "epochs"}
        self._acks: Dict[str, dict] = {}  #: guarded-by _lock
        self._next_snap_push: Dict[str, float] = {}  #: guarded-by _lock
        self.stats: Dict[str, int] = {  #: guarded-by _lock
            "rounds": 0, "delta_pushes": 0, "delta_bytes": 0,
            "snapshot_pushes": 0, "snapshot_bytes": 0,
            "heartbeat_pushes": 0, "heartbeat_bytes": 0,
            "pull_deltas": 0, "pull_snapshots": 0}
        # tombstones must comfortably outlive the reconciliation window
        # (a follower that missed a few gossip rounds catches up by
        # delta, not snapshot); only a long partition falls behind the
        # horizon
        self.tombstone_ttl = (tombstone_ttl if tombstone_ttl is not None
                              else max(30.0, 20 * lease_ttl))
        if peers is not None:
            peer_list = list(peers)
            su = self_uri or (engine.uri if engine.uri in peer_list
                              else None)
            if su is None:
                raise ValueError(
                    f"engine uri {engine.uri!r} is not in peers "
                    f"{peer_list!r}; pass self_uri= explicitly")
            self.tracker: Optional[PeerTracker] = PeerTracker(
                peer_list, su, lease_ttl=lease_ttl)
            self.self_uri = su
            self._leading = False  #: guarded-by _lock (elected by gossip)
        else:
            self.tracker = None
            self.self_uri = engine.uri
            self._leading = True          # single node: always the leader
        self._proxy_timeout = max(0.5, min(2.0, lease_ttl))
        # gossip probes must resolve well inside the lease: a black-holed
        # peer burning a full proxy_timeout per tick would starve contact
        # with live peers and flap leadership
        self._gossip_timeout = max(0.2, min(self._proxy_timeout,
                                            lease_ttl / 2))
        # snapshot cadence: the full-state mode's periodic push, and the
        # delta mode's per-peer rate limit for unacked (dead or cold)
        # peers
        self._full_push_every = max(1.0, gossip_interval)
        self._next_full_push = 0.0  #: guarded-by _lock
        self._sweep_interval = sweep_interval
        self._sweeper = threading.Thread(
            target=self._sweep_loop, args=(sweep_interval,), daemon=True,
            name="fabric-ctrl-sweep")
        self._gossiper: Optional[threading.Thread] = None
        if self.tracker is not None:
            engine.register(rpc_name, self._gossip)
            self._gossiper = threading.Thread(
                target=self._gossip_loop, daemon=True,
                name="fabric-ctrl-gossip")
        self._started = False
        if autostart:
            self.start()

    def start(self) -> None:
        """Start the sweeper (and, in quorum mode, the gossip loop).
        Separated from construction so a host service can finish
        attaching its tables and wire handlers *before* the node begins
        sweeping/electing — with ``autostart=False`` nothing runs until
        everything the quorum replicates is in place (idempotent)."""
        if self._started:
            return
        self._started = True
        self._sweeper.start()
        if self._gossiper is not None:
            self._gossiper.start()

    # -- tables --------------------------------------------------------------
    def table(self, name: str, ttl: Optional[float] = None
              ) -> ReplicatedTable:
        """Get-or-create the named table.  A table may be auto-created
        earlier by gossip (a peer replicated it before the local service
        attached); attaching sets its TTL."""
        with self._lock:
            t = self.tables.get(name)
            if t is None:
                t = ReplicatedTable(name, self._lock, ttl=ttl,
                                    tombstone_ttl=self.tombstone_ttl,
                                    dirty_cb=self._dirty.set)
                self.tables[name] = t
            elif ttl is not None:
                t.ttl = ttl
            return t

    def add_tick_hook(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` at the top of every gossip tick (quorum mode) —
        the retry loop for cross-node bookkeeping like pending reaps."""
        self._tick_hooks.append(cb)

    def mark_dirty(self) -> None:
        self._dirty.set()

    # -- leadership ----------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._leading

    def leader_for_writes(self) -> Optional[str]:
        """None if this replica may apply writes locally; otherwise the
        leaseholder to proxy to.  Raises ``AGAIN`` while leadership is
        unsettled (boot grace / takeover pending) — retryable:
        :class:`QuorumCaller` keeps re-probing the quorum within its own
        timeout budget until the lease settles."""
        if self.tracker is None or self.is_leader:
            return None
        lead = self.tracker.leader_uri()
        if lead is None or lead == self.self_uri:
            raise MercuryError(Ret.AGAIN,
                               "control-plane leadership unsettled; retry")
        return lead

    def proxy(self, leader: str, name: str, req: dict):
        """Forward a write to the leaseholder (one hop only: a proxied
        write that lands on another follower fails fast with AGAIN
        rather than bouncing around a partitioned quorum)."""
        if req.get("_proxied"):
            raise MercuryError(Ret.AGAIN,
                               "control-plane leadership unsettled; retry")
        # child of the ambient server span (the handler that received the
        # client's write): the trace shows follower hop -> leader hop
        span = _trace.start_span(f"proxy.{name}", _trace.current(),
                                 leader=leader)
        try:
            with _trace.use(span.ctx):
                out = self.engine.call(leader, name,
                                       dict(req, _proxied=True),
                                       timeout=self._proxy_timeout)
            span.finish("OK")
            return out
        except MercuryError as e:
            span.finish(e.ret.name)
            if e.ret in FAILOVER_RETS:
                raise MercuryError(
                    Ret.AGAIN, f"control-plane leader {leader} unreachable "
                    f"({e.ret.name}); retry") from e
            raise                         # application error: handler ran
        except Exception as e:
            span.finish(type(e).__name__)
            raise

    def _take_over(self) -> None:
        """Become the leaseholder: start a fresh epoch stream (new nonce
        → every client resyncs) and refresh all liveness stamps so the
        takeover itself cannot mass-expire entries that could not
        heartbeat while the old leader was dead."""
        now = time.monotonic()
        with self._lock:
            self._leading = True
            self.nonce = uuid.uuid4().hex[:12]
            self._acks.clear()
            for t in self.tables.values():
                t.bump()
                t.refresh_liveness(now)
        self._dirty.set()                 # announce the new stream now

    # -- reconciliation ------------------------------------------------------
    def _may_adopt(self, frm: str) -> bool:
        """Adopted from lower-rank (higher-priority) peers always — that
        is also how a deposed leader steps down — and from *any* acting
        leader during boot grace, so a restarted high-priority replica
        resyncs before it reclaims the lease."""
        tr = self.tracker
        return tr is not None and (
            tr.in_grace()
            or tr.rank.get(frm, 99) < tr.rank[self.self_uri])

    def _adopt_snapshot(self, frm: str, nonce: str,
                        snaps: Dict[str, dict]) -> None:
        """Full-state overwrite keyed by (nonce, epoch)."""
        if not self._may_adopt(frm):
            return
        now = time.monotonic()
        with self._lock:
            if nonce == self.nonce and any(
                    int(s["epoch"]) < self.tables[n].epoch
                    for n, s in snaps.items() if n in self.tables):
                return                    # stale push of our own stream
            # equal-epoch snapshots of our own stream ARE adopted: in
            # full-gossip mode the leader's periodic snapshot is how
            # mirrored soft state (loads, liveness ages) stays fresh
            # between membership changes
            self._leading = False
            self.nonce = nonce
            for name, snap in snaps.items():
                self.table(name).install(snap, now)
        self.tracker.mark_synced()

    def _apply_deltas(self, frm: str, nonce: str,
                      deltas: Dict[str, dict]) -> None:
        """Apply a leader's per-table deltas.  Only connects within one
        stream (same nonce); a gap (delta base past our epoch) is left
        unapplied — our next heartbeat advertises the low epoch and the
        leader answers with a snapshot."""
        if not self._may_adopt(frm):
            return
        now = time.monotonic()
        with self._lock:
            if nonce != self.nonce or self._leading:
                return
            for name, d in deltas.items():
                t = self.table(name)
                if t.apply_delta(d, now):
                    t.apply_soft(d.get("soft", ()), now)

    # -- gossip wire ---------------------------------------------------------
    def _epochs_locked(self) -> Dict[str, int]:
        return {n: t.epoch for n, t in self.tables.items()}

    def _snapshots_locked(self, now: float) -> Dict[str, dict]:
        return {n: t.snapshot(now) for n, t in self.tables.items()}

    def _catchup_locked(self, peer_nonce, peer_epochs: dict,
                        now: float) -> Tuple[str, dict]:
        """Build what a behind peer needs: ``("delta", {...})`` when its
        acked epochs connect to our tombstone history, else
        ``("snapshot", {...})``."""
        if self.delta_gossip and peer_nonce == self.nonce:
            deltas = {}
            for name, t in self.tables.items():
                base = int((peer_epochs or {}).get(name, 0))
                if base == t.epoch:
                    continue
                d = t.delta_since(base, now)
                if d is None:             # behind the horizon: resync
                    return "snapshot", self._snapshots_locked(now)
                deltas[name] = d
            return "delta", deltas
        return "snapshot", self._snapshots_locked(now)

    def _gossip(self, req):
        """Peer-to-peer state exchange.  The leader pushes deltas (or
        snapshots for unsynced peers); followers heartbeat with their
        mirrored (nonce, epochs) and are answered with a catch-up
        payload whenever they are behind."""
        frm = req.get("from")
        if self.tracker is None or frm not in self.tracker.rank:
            raise MercuryError(Ret.INVALID_ARG,
                               f"gossip from unknown peer {frm!r}")
        self.tracker.note(frm)
        if req.get("snapshot") is not None:
            self._adopt_snapshot(frm, req["nonce"], req["snapshot"])
        if req.get("delta") is not None:
            self._apply_deltas(frm, req["nonce"], req["delta"])
        now = time.monotonic()
        with self._lock:
            resp = {"nonce": self.nonce, "epochs": self._epochs_locked()}
            if self._leading:
                # the requester's heartbeat doubles as its ack
                self._acks[frm] = {"nonce": req.get("nonce"),
                                   "epochs": dict(req.get("epochs") or {})}
                behind = (req.get("nonce") != self.nonce
                          or any(int((req.get("epochs") or {}).get(n, 0))
                                 < t.epoch
                                 for n, t in self.tables.items()))
                if behind:
                    kind, pay = self._catchup_locked(
                        req.get("nonce"), req.get("epochs"), now)
                    if pay:
                        resp[kind] = pay
                        self.stats["pull_deltas" if kind == "delta"
                                   else "pull_snapshots"] += 1
        return resp

    def _gossip_loop(self) -> None:
        while not self._stop.is_set():
            dirty = self._dirty.wait(self.gossip_interval)
            self._dirty.clear()
            if self._stop.is_set():
                return
            try:
                self._gossip_tick(dirty)
            except Exception:
                pass                      # gossip must never die

    def _build_pushes_locked(self, dirty: bool, now: float
                             ) -> List[Tuple[str, dict]]:
        """One payload per peer.  Followers always send the bare
        heartbeat; the leader attaches per-peer deltas / rate-limited
        snapshots as each peer's ack requires."""
        base = {"from": self.self_uri, "leader": self._leading,
                "nonce": self.nonce, "epochs": self._epochs_locked()}
        peers = self.tracker.others()
        if not self._leading:
            return [(p, base) for p in peers]
        if not self.delta_gossip:
            # PR-4 full-state protocol: snapshot rides membership
            # changes immediately and a slow periodic cadence otherwise
            payload = dict(base)
            if dirty or now >= self._next_full_push:
                payload["snapshot"] = self._snapshots_locked(now)
                self._next_full_push = now + self._full_push_every
            return [(p, payload) for p in peers]
        # delta mode: coalesced soft records (shared across peers) +
        # per-peer versioned deltas from each acked epoch
        soft = {n: t.take_soft(now) for n, t in self.tables.items()}
        soft = {n: s for n, s in soft.items() if s}
        out = []
        snaps = None
        for peer in peers:
            ack = self._acks.get(peer)
            if (ack is None or ack.get("nonce") != self.nonce
                    or not self.tracker.is_alive(peer)):
                # unsynced (cold or restarted) or lease-dead peer: full
                # snapshot, rate-limited so a dead peer does not cost a
                # snapshot (or ever-growing delta) encode every tick —
                # a dead peer's last ack is frozen, so without the
                # is_alive check it would ride the catch-up path below
                # on every tick forever.  A *live* cold peer is caught
                # up faster via the pull path anyway
                if now >= self._next_snap_push.get(peer, 0.0):
                    if snaps is None:
                        snaps = self._snapshots_locked(now)
                    out.append((peer, dict(base, snapshot=snaps)))
                    self._next_snap_push[peer] = (now
                                                  + self._full_push_every)
                else:
                    out.append((peer, base))
                continue
            kind, pay = self._catchup_locked(ack["nonce"], ack["epochs"],
                                             now)
            if kind == "snapshot":
                out.append((peer, dict(base, snapshot=pay)))
                continue
            deltas = pay
            for name, s in soft.items():
                d = deltas.setdefault(
                    name, {"base": self.tables[name].epoch,
                           "epoch": self.tables[name].epoch,
                           "put": [], "del": []})
                d["soft"] = s
            if deltas:
                out.append((peer, dict(base, delta=deltas)))
            else:
                out.append((peer, base))
        return out

    def _gossip_tick(self, dirty: bool = False) -> None:
        # Leadership changes hands in exactly two places: here (the
        # lease says every higher-priority peer is dead, or — after boot
        # grace — that we are the highest-priority survivor), and in
        # _adopt_snapshot (a higher-priority peer's push deposes us).
        # An acting leader does NOT step down merely because a
        # higher-priority peer reappeared: it keeps serving until that
        # peer has adopted its snapshot and taken over — otherwise a
        # restarted rank-0 replica could seize the lease with an empty
        # table before it resynced.
        if (self.tracker.leader_uri() == self.self_uri
                and not self.is_leader):
            self._take_over()
            dirty = True
        for hook in self._tick_hooks:
            try:
                hook()
            except Exception:
                pass
        now = time.monotonic()
        with self._lock:
            pushes = self._build_pushes_locked(dirty, now)
        # size/classify the payloads OUTSIDE the lock: the stats encode
        # of a large snapshot would otherwise stall every inline read
        # handler (fab.resolve/fab.epoch/mem.view) contending on it
        sized = []
        for _, payload in pushes:
            kind = ("snapshot" if "snapshot" in payload
                    else "delta" if "delta" in payload
                    else "heartbeat")
            sized.append((kind, _payload_bytes(payload)))
        with self._lock:
            self.stats["rounds"] += 1
            for kind, nbytes in sized:
                self.stats[f"{kind}_pushes"] += 1
                self.stats[f"{kind}_bytes"] += nbytes
        # parallel fan-out, bounded well inside the lease: one
        # black-holed peer must not delay contact with live peers past
        # lease_ttl (serialized full-timeout probes would flap leases)
        futs = []
        for peer, payload in pushes:
            try:
                futs.append((peer, self.engine.call_async(
                    peer, self.rpc_name, payload,
                    timeout=self._gossip_timeout)))
            except Exception:
                continue
        for peer, fut in futs:
            try:
                resp = fut.result(timeout=self._gossip_timeout + 0.25)
            except Exception:
                continue                  # lease decays on silence
            self.tracker.note(peer)
            if not isinstance(resp, dict):
                continue
            if resp.get("snapshot") is not None:
                self._adopt_snapshot(peer, resp["nonce"], resp["snapshot"])
            if resp.get("delta") is not None:
                self._apply_deltas(peer, resp["nonce"], resp["delta"])
            with self._lock:
                if self._leading:
                    self._acks[peer] = {
                        "nonce": resp.get("nonce"),
                        "epochs": dict(resp.get("epochs") or {})}

    # -- sweeping ------------------------------------------------------------
    def _sweep_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            now = time.monotonic()
            with self._lock:
                if not self._leading:
                    continue              # followers mirror; only the
                tables = list(self.tables.values())  # leaseholder expires
            for t in tables:
                dead = t.expire(now)
                if dead:
                    t.fire_expired(dead)  # outside the core lock

    # -- observability -------------------------------------------------------
    def status(self) -> dict:
        """Control-plane health: role, believed leaseholder, per-table
        entry counts/epochs, gossip delta-vs-snapshot counters, and the
        last acked (nonce, epochs) per peer (docs/OPERATIONS.md)."""
        with self._lock:
            base = {"self": self.self_uri, "nonce": self.nonce,
                    "tables": {n: t.status()
                               for n, t in self.tables.items()},
                    "gossip": dict(self.stats)}
            acks = {p: dict(a) for p, a in self._acks.items()}
            leading = self._leading
        if self.tracker is None:
            return dict(base, role="single", leader=self.self_uri,
                        peers=[])
        role = ("leader" if leading
                else "booting" if self.tracker.in_grace() else "follower")
        peers = []
        for p in self.tracker.peer_stats():
            ack = acks.get(p["uri"])
            if ack is not None:
                p = dict(p, acked_nonce=ack.get("nonce"),
                         acked=ack.get("epochs") or {})
            peers.append(p)
        return dict(base, role=role, leader=self.tracker.leader_uri(),
                    peers=peers)

    def close(self) -> None:
        """Stop and join the sweeper and gossip threads (idempotent)."""
        self._stop.set()
        self._dirty.set()                 # wake a parked gossip loop
        if self._started and self._sweeper.is_alive():
            self._sweeper.join(timeout=2.0)
        if (self._started and self._gossiper is not None
                and self._gossiper.is_alive()):
            self._gossiper.join(timeout=2.0)

    stop = close


class QuorumCaller:
    """Sticky-failover RPC calls over a control-plane address set.

    ``uris`` is one endpoint per replica (list, or one comma-separated
    string).  Calls stick to the endpoint that last answered and rotate
    to the next replica on transport-class failures (dead peer,
    unsettled leadership) — any live replica can serve reads and proxies
    writes to the leaseholder, so the caller never needs to know who
    leads.  Worst case a call probes every endpoint once
    (``len(uris) × timeout``)."""

    def __init__(self, engine, uris, timeout: float = 10.0):
        self.engine = engine
        self.uris = parse_registry_uris(uris)
        self.timeout = timeout
        self._idx = 0
        self._idx_lock = threading.Lock()

    @property
    def current(self) -> str:
        """The currently preferred endpoint (observability/tests)."""
        with self._idx_lock:
            return self.uris[self._idx]

    def call(self, name: str, req: dict):
        # One rotation over the endpoints; if every replica answered
        # AGAIN (leadership unsettled: cold-quorum boot grace, or the
        # lease mid-failover) the quorum is alive but momentarily
        # unwritable, so keep retrying within the call's own timeout
        # budget rather than surfacing a transient to the caller —
        # ServiceInstance/ServingGateway constructors race quorum
        # startup in any real deployment.
        deadline = time.monotonic() + self.timeout
        while True:
            with self._idx_lock:
                start = self._idx
            last: Optional[MercuryError] = None
            all_again = True
            for k in range(len(self.uris)):
                i = (start + k) % len(self.uris)
                try:
                    out = self.engine.call(self.uris[i], name, req,
                                           timeout=self.timeout)
                except MercuryError as e:
                    if e.ret not in FAILOVER_RETS:
                        raise             # application error: surfaced
                    last = e
                    all_again = all_again and e.ret == Ret.AGAIN
                    continue
                with self._idx_lock:
                    self._idx = i         # sticky: keep the live replica
                return out
            if last is None:
                raise MercuryError(Ret.NOENTRY,
                                   "empty control-plane address set")
            if not all_again or time.monotonic() + 0.1 >= deadline:
                raise last
            time.sleep(0.1)               # unsettled leadership: re-probe
