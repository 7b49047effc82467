"""Client-side idempotent read cache (DESIGN.md §9).

Control-plane reads — ``fab.resolve``, ``fab.epoch``, ``mem.view``,
``ckpt.list`` — are *declared idempotent*: within one authoritative
``(nonce, epoch)`` token they always return the same answer, so a
client that issues them in a hot loop (every pool refresh tick, every
hedged attempt) is paying registry round-trips for bytes it already
holds.  :class:`ReadCache` collapses those calls:

  * entries are keyed ``(method, args-digest)`` where the digest is the
    proc encoding of the arguments — the same canonical form the wire
    would carry, so two calls that would serialize identically share an
    entry;
  * an entry is valid only while (a) its ``(nonce, epoch)`` token
    matches the last token observed from the authority and (b) its TTL
    has not lapsed.  Epoch bumps, nonce changes (registry restart,
    leader failover) and TTL expiry each evict — there is no path that
    serves a read from a superseded epoch stream;
  * concurrent misses on one key **singleflight**: the first caller
    runs the fetch, everyone else waits on its future.  Only a
    *successful* result populates the cache — a fetch that fails (or is
    canceled, e.g. a hedged loser) propagates to its waiters and caches
    nothing, so a canceled loser can never poison later reads.

The cache is deliberately a dumb value store: invalidation is driven
entirely by the token its owner feeds via :meth:`observe` (clients call
it with every epoch they learn — from ``fab.epoch`` polls *and* from
write responses, so a client observes its own writes immediately).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from hashlib import blake2b
from typing import Any, Callable, Dict, Optional, Tuple

from ..core import proc as hg_proc
from ..telemetry import metrics as _metrics

# (nonce, epoch) pair identifying one point in one authoritative stream
Token = Tuple[Optional[str], int]

# unified metrics: process-wide totals across every cache instance
# (per-instance detail stays in stats(); fab.metrics exports these)
_M_HITS = _metrics.counter("fabric.readcache.hits")
_M_MISSES = _metrics.counter("fabric.readcache.misses")
_M_EVICTIONS = _metrics.counter("fabric.readcache.evictions")


def args_digest(method: str, args: Any) -> bytes:
    """Canonical cache key for an RPC read: digest of the proc encoding
    of ``(method, args)`` — exactly what the wire would carry."""
    enc = hg_proc.encode(hg_proc.proc_any, {"m": method, "a": args})
    return blake2b(bytes(enc), digest_size=16).digest()


class ReadCache:
    """TTL + token keyed cache with singleflight collapse.

    ``ttl`` bounds how long a hit may be served without re-checking the
    authority even when no invalidation arrived (the freshness bound for
    staleness the token cannot see, e.g. load values that do not bump
    the epoch).  ``ttl=0`` disables caching entirely (every read goes
    through) while keeping singleflight collapse for concurrent misses.
    """

    def __init__(self, ttl: float = 0.25, max_entries: int = 256):
        self.ttl = ttl
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._token: Token = (None, -1)  #: guarded-by _lock
        # key -> (token, expires_at, value)
        self._entries: Dict[bytes, Tuple[Token, float, Any]] = {}  #: guarded-by _lock
        self._inflight: Dict[bytes, Future] = {}  #: guarded-by _lock
        self._hits = 0  #: guarded-by _lock
        self._misses = 0  #: guarded-by _lock
        self._evictions = 0  #: guarded-by _lock

    # -- invalidation --------------------------------------------------------
    def observe(self, nonce: Optional[str], epoch: int) -> bool:
        """Feed the latest authoritative ``(nonce, epoch)``.  Advancing
        the token (new nonce, or higher epoch on the same nonce) evicts
        every cached entry; returns True if it did.  A *lower* epoch on
        the same nonce is a stale read racing a newer one — ignored."""
        with self._lock:
            cur = self._token
            if nonce == cur[0] and epoch <= cur[1]:
                return False
            self._token = (nonce, epoch)
            if self._entries:
                self._evictions += len(self._entries)
                _M_EVICTIONS.inc(len(self._entries))
                self._entries.clear()
            return True

    def observe_epoch(self, epoch: int) -> bool:
        """Observe an epoch on the *current* nonce (write responses
        carry the epoch but not the nonce)."""
        with self._lock:
            nonce = self._token[0]
        return self.observe(nonce, epoch)

    def invalidate(self) -> None:
        """Drop every entry without advancing the token (e.g. a client
        that just wrote through a path whose new epoch it cannot see)."""
        with self._lock:
            self._evictions += len(self._entries)
            _M_EVICTIONS.inc(len(self._entries))
            self._entries.clear()

    # -- lookup --------------------------------------------------------------
    def get_or_call(self, method: str, args: Any,
                    fetch: Callable[[], Any], fresh: bool = False,
                    token_of: Optional[Callable[[Any], Token]] = None) -> Any:
        """Serve ``(method, args)`` from cache, or run ``fetch()`` once
        (singleflighted across threads) and cache its result under the
        current token.  ``fresh=True`` bypasses the cached value but
        still populates (and still collapses concurrent fetches).

        ``token_of(value)`` extracts the authoritative ``(nonce,
        epoch)`` carried *in the response* (e.g. ``fab.resolve`` returns
        both): the result is observed — advancing the cache token and
        evicting anything older — and then cached under its own token,
        so a read that itself reveals an epoch bump both invalidates the
        stale view and seeds the fresh one."""
        key = args_digest(method, args)
        while True:
            with self._lock:
                if not fresh and self.ttl > 0:
                    ent = self._entries.get(key)
                    if ent is not None:
                        token, expires, value = ent
                        if token == self._token and time.monotonic() < expires:
                            self._hits += 1
                            _M_HITS.inc()
                            return value
                        self._entries.pop(key, None)
                        self._evictions += 1
                        _M_EVICTIONS.inc()
                fut = self._inflight.get(key)
                if fut is None:
                    fut = Future()
                    self._inflight[key] = fut
                    owner = True
                else:
                    owner = False
                token = self._token
            if not owner:
                # another thread is fetching this key: ride its result.
                # Its failure propagates here too — both callers see the
                # same error, neither caches it.
                return fut.result()
            try:
                value = fetch()
            except BaseException as e:
                with self._lock:
                    self._inflight.pop(key, None)
                fut.set_exception(e)
                raise
            if token_of is not None:
                token = token_of(value)
                self.observe(*token)
            with self._lock:
                self._inflight.pop(key, None)
                # populate only under the *current* token — a result
                # raced by a newer invalidation may be from either side
                # of the bump, so it must not stick
                if self.ttl > 0 and token == self._token:
                    if len(self._entries) >= self.max_entries:
                        self._entries.pop(next(iter(self._entries)))
                        self._evictions += 1
                        _M_EVICTIONS.inc()
                    self._entries[key] = (token, time.monotonic() + self.ttl,
                                          value)
                self._misses += 1
                _M_MISSES.inc()
            fut.set_result(value)
            return value

    # -- observability -------------------------------------------------------
    def token(self) -> Token:
        """The current ``(nonce, epoch)`` authority token.  One token
        per cache instance: sharded clients hold one cache per shard
        precisely so these never mix (DESIGN.md §12)."""
        with self._lock:
            return self._token

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "entries": len(self._entries),
                    "token": {"nonce": self._token[0],
                              "epoch": self._token[1]}}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
