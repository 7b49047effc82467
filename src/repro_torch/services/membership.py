"""Membership / heartbeat service — the fault-tolerance control plane.

A coordinator tracks live members; an *epoch* counter bumps whenever the
member set changes (join, leave, heartbeat timeout).  Training drivers
poll the epoch each step: on change they rebuild the mesh from the
survivors and restore from the checkpoint service (elastic scaling +
node-failure recovery, exercised in tests and the elastic example).

The member table is a
:class:`~repro_torch.fabric.replication.ReplicatedTable`.  Standalone
(``MembershipServer(engine)``) it rides a private single-node
replication core — the original per-node coordinator, wire API
unchanged.  Passed the core of a registry quorum (``core=``, wired by
``RegistryService(serve_membership=True)``) the member table is
**replicated across the quorum** alongside the instance table: one
leader lease, one delta-gossip stream, follower-served ``mem.view``
reads, writes (``mem.join``/``mem.leave``/``mem.heartbeat``) proxied
one hop to the leaseholder.  Member liveness and expiry hooks then
survive leaseholder death: a takeover refreshes every member's
heartbeat stamp (no mass-expiry) and subsequent expiries fire on the
new leader — exactly once, since only the leaseholder sweeps.

Views carry a per-run **nonce** (the same scheme the registry uses,
DESIGN.md §7/§8): epochs are only comparable within one coordinator run
*or lease tenure*, so a driver comparing ``view["epoch"]`` across a
coordinator restart or a quorum failover can detect the reset (nonce
changed → resync) instead of treating the reset-to-small epoch as stale
forever.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..core.executor import Engine
from ..fabric.readcache import ReadCache
from ..fabric.replication import QuorumCaller, ReplicationCore


class MembershipServer:
    """Hosts the ``mem.*`` RPCs.  ``core=None`` runs the classic
    single-node coordinator; pass a quorum's
    :class:`~repro_torch.fabric.replication.ReplicationCore` to serve the
    member table replicated (every quorum node hosts ``mem.*``)."""

    def __init__(self, engine: Engine, heartbeat_timeout: float = 2.0,
                 sweep_interval: float = 0.5,
                 core: Optional[ReplicationCore] = None):
        self.engine = engine
        self.timeout = heartbeat_timeout
        self._owns_core = core is None
        if core is None:
            core = ReplicationCore(engine, sweep_interval=sweep_interval)
        self.core = core
        self.table = core.table("members", ttl=heartbeat_timeout)
        self._expire_cbs: List[Callable[[List[str]], None]] = []
        self.table.on_expire(self._fire_expired)
        # mem.join/leave/heartbeat proxy to the leaseholder in quorum
        # mode — nested blocking calls, so they stay off the progress
        # thread; mem.view is a pure local read
        engine.register("mem.join", self._join)
        engine.register("mem.leave", self._leave)
        engine.register("mem.heartbeat", self._heartbeat)
        engine.register("mem.view", self._view, inline=True)

    # -- compat --------------------------------------------------------------
    @property
    def members(self) -> Dict[str, dict]:
        return dict(self.table.items())

    @property
    def epoch(self) -> int:
        return self.table.epoch

    @property
    def nonce(self) -> str:
        return self.core.nonce

    @property
    def _sweeper(self) -> threading.Thread:
        return self.core._sweeper

    # -- handlers ------------------------------------------------------------
    def _view_locked(self):
        with self.core._lock:
            items = self.table.items()
            return {"epoch": self.table.epoch, "nonce": self.core.nonce,
                    "members": sorted(k for k, _ in items),
                    "uris": {k: v["uri"] for k, v in items}}

    def _join(self, req):
        lead = self.core.leader_for_writes()
        if lead is not None:
            return self.core.proxy(lead, "mem.join", req)
        mid = req["member_id"]
        with self.core._lock:
            self.table.put(mid, {"uri": req.get("uri", ""),
                                 "meta": req.get("meta", {})})
            return self._view_locked()

    def _leave(self, req):
        lead = self.core.leader_for_writes()
        if lead is not None:
            return self.core.proxy(lead, "mem.leave", req)
        with self.core._lock:
            left = self.table.delete(req["member_id"])
            view = self._view_locked()
        if left:
            self._fire_expired([req["member_id"]])
        return view

    def _heartbeat(self, req):
        lead = self.core.leader_for_writes()
        if lead is not None:
            return self.core.proxy(lead, "mem.heartbeat", req)
        mid = req["member_id"]
        with self.core._lock:
            if not self.table.update(mid):
                # expired member re-announcing: treat as a join —
                # preserving any metadata it carries, exactly like
                # _join does (a re-join with meta={} would silently
                # drop the member's registered metadata)
                self.table.put(mid, {"uri": req.get("uri", ""),
                                     "meta": req.get("meta", {})})
            return self._view_locked()

    def _view(self, _req):
        return self._view_locked()

    # -- expiry hooks (e.g. the service registry reaping instances whose
    # member died) -----------------------------------------------------------
    def on_expire(self, cb: Callable[[List[str]], None]) -> None:
        """Register ``cb(dead_member_ids)``; fired after a heartbeat
        sweep or an explicit leave removed members (outside the lock,
        on the node holding the lease)."""
        self._expire_cbs.append(cb)

    def _fire_expired(self, dead: List[str]) -> None:
        for cb in self._expire_cbs:
            try:
                cb(dead)
            except Exception:
                pass                      # hooks must not kill the sweeper

    def close(self):
        """Graceful stop (idempotent).  A private single-node core is
        closed (joining its sweeper); a shared quorum core belongs to
        the RegistryService that created it."""
        if self._owns_core:
            self.core.close()

    stop = close


class MembershipClient:
    """Member-side wrapper over ``mem.*``.  ``server_uri`` may be one
    coordinator endpoint or a whole quorum address set (comma-separated
    or list): calls stick to the replica that last answered and rotate
    on dead-peer detection — any quorum node serves views and proxies
    writes to the leaseholder.  Heartbeats carry the member's join
    metadata so an expiry-then-reannounce round trip (e.g. a long GC
    pause) restores it instead of rejoining with ``meta={}``.

    ``cache_ttl > 0`` turns on the idempotent read cache for
    ``mem.view`` (DESIGN.md §9): repeat ``current_view()`` calls within
    the TTL are served locally, evicted the moment any view the client
    sees — including its own heartbeats — carries a newer
    ``(nonce, epoch)``."""

    def __init__(self, engine: Engine, server_uri, member_id: str,
                 heartbeat_interval: float = 0.5,
                 on_change: Optional[Callable[[dict], None]] = None,
                 cache_ttl: float = 0.0):
        from ..fabric.sharding import membership_home
        self.engine = engine
        # membership is unsharded and rides shard 0 (DESIGN.md §12), so
        # a sharded registry spec reduces to its home shard here
        self._caller = QuorumCaller(engine, membership_home(server_uri),
                                    timeout=5.0)
        self.member_id = member_id
        self.interval = heartbeat_interval
        self.on_change = on_change
        self.cache = ReadCache(ttl=cache_ttl)
        self.meta: dict = {}
        self.view: dict = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def server(self) -> str:
        """The currently preferred endpoint (observability/tests)."""
        return self._caller.current

    @staticmethod
    def _token_of(view: dict):
        return view.get("nonce"), view["epoch"]

    def join(self, meta: Optional[dict] = None) -> dict:
        self.meta = meta or {}
        self.view = self._caller.call("mem.join", {
            "member_id": self.member_id, "uri": self.engine.uri,
            "meta": self.meta})
        self.cache.observe(*self._token_of(self.view))
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()
        return self.view

    def _beat(self):
        while not self._stop.wait(self.interval):
            try:
                view = self._caller.call("mem.heartbeat",
                                         {"member_id": self.member_id,
                                          "uri": self.engine.uri,
                                          "meta": self.meta})
            except Exception:
                continue
            self.cache.observe(*self._token_of(view))
            # epochs are only comparable within one (nonce) stream: a
            # coordinator restart or quorum failover mints a new nonce
            # and must fire on_change even if the epoch looks equal/lower
            changed = (view["epoch"] != self.view.get("epoch")
                       or view.get("nonce") != self.view.get("nonce"))
            if changed and self.on_change:
                self.on_change(view)
            self.view = view

    def current_view(self, fresh: bool = False) -> dict:
        return self.cache.get_or_call(
            "mem.view", {}, lambda: self._caller.call("mem.view", {}),
            fresh=fresh, token_of=self._token_of)

    def leave(self):
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2.0)
        try:
            self._caller.call("mem.leave", {"member_id": self.member_id})
        except Exception:
            pass

    close = leave
