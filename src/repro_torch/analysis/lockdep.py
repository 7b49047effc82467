"""lockdep — the port's copy of the runtime lock-order sanitizer.

It tracks locks created under ``repro_torch/`` and hooks the port's own
RPC core; call :func:`install` before the port's fabric is imported
(``tests/test_torch_lockdep.py`` does so in a subprocess).  It is the
reference's ``repro/analysis/lockdep.py`` with the site prefix changed
to the port's package.  :func:`install` monkeypatches the
``threading.Lock`` / ``RLock`` / ``Condition`` factories so every lock
subsequently *created from fabric code* is wrapped in a
:class:`TrackedLock`.  Locks are keyed by **creation site**
(``file:line``), the classic lockdep move: every ``ReplicationCore``
instance's ``_lock`` shares one key, so an ordering observed between
two instances in a test generalizes to the fleet.

What it records:

  * the cross-thread **acquisition-order graph**: an edge A→B each
    time a thread acquires a B-site lock while holding an A-site lock.
    Adding an edge that closes a directed cycle is a potential
    deadlock — recorded as a violation (same-site edges are skipped:
    two instances of one class may nest by protocol, e.g. a sender
    touching a peer's inbox lock after releasing its own).
  * **locks held across an RPC boundary**: ``Handle.forward`` and the
    blocking ``Engine.call`` / ``pull`` / ``push`` are hooked; entering
    any of them with a tracked lock held is a violation (a remote
    round-trip under a local lock is a distributed lock-hold).
  * per-site **hold-time histograms**, exported through the PR-7
    metrics registry as ``analysis.lock.hold_ms{site=...}`` — sites
    are a bounded set, so this respects the cardinality policy.

The wrapper keeps the full lock protocol — including the private
``_is_owned`` / ``_release_save`` / ``_acquire_restore`` hooks
``threading.Condition`` uses — so condition variables built over
tracked locks (``Condition(self._cq_lock)``, the default
``Condition()``) keep working, and a ``cv.wait()`` correctly drops the
lock from the thread's held-stack while parked.

Tests can use the machinery without global patching::

    g = lockdep.LockGraph(metrics=False)
    a = lockdep.wrap(threading.Lock(), "A", g)
    b = lockdep.wrap(threading.Lock(), "B", g)
    ...
    assert not g.report()["cycles"]
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition

# never track locks created inside these files: the metrics registry's
# own locks would recurse through the hold-time export, and threading.py
# internals (Event, Queue plumbing) are not fabric locks
_EXCLUDE_PARTS = (os.path.join("telemetry", "metrics.py"), "threading.py")

_MAX_VIOLATIONS = 64


def _site_of(frame) -> str:
    fn = frame.f_code.co_filename.replace(os.sep, "/")
    idx = fn.rfind("repro_torch/")
    if idx < 0:
        idx = fn.rfind("tests/")
    short = fn[idx:] if idx >= 0 else os.path.basename(fn)
    return f"{short}:{frame.f_lineno}"


class LockGraph:
    """Acquisition-order graph + violation log (one per install; tests
    may build private instances)."""

    def __init__(self, metrics: bool = True):
        self._mu = _REAL_LOCK()          # internal — never tracked
        self._tls = threading.local()
        # edges[a][b] = thread name that first observed a→b
        self.edges: Dict[str, Dict[str, str]] = {}
        self.cycles: List[dict] = []
        self.rpc_violations: List[dict] = []
        self.acquisitions = 0
        self._metrics = metrics
        self._hist = None

    # -- per-thread held stack --------------------------------------------

    def _stack(self) -> List[Tuple[object, float]]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def held_sites(self) -> List[str]:
        """Distinct sites of locks the current thread holds, outermost
        first."""
        seen, out = set(), []
        for lock, _t in self._stack():
            if lock.site not in seen:
                seen.add(lock.site)
                out.append(lock.site)
        return out

    def owns(self, lock: "TrackedLock") -> bool:
        return any(entry[0] is lock for entry in self._stack())

    # -- events ------------------------------------------------------------

    def note_acquire(self, lock: "TrackedLock") -> None:
        st = self._stack()
        self.acquisitions += 1
        if not any(e[0] is lock for e in st):      # not a re-entry
            held = []
            seen = set()
            for other, _t in st:
                if other.site != lock.site and other.site not in seen:
                    seen.add(other.site)
                    held.append(other.site)
            for site in held:
                self._add_edge(site, lock.site)
        st.append((lock, time.monotonic()))

    def note_release(self, lock: "TrackedLock") -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is lock:
                _l, t0 = st.pop(i)
                if not any(e[0] is lock for e in st):
                    self._observe_hold(lock.site, time.monotonic() - t0)
                return

    def note_release_all(self, lock: "TrackedLock") -> int:
        """Condition._release_save on an RLock: drop every recursion
        level.  Returns the count so the restore can push them back."""
        st = self._stack()
        n = 0
        t0 = None
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] is lock:
                t0 = st.pop(i)[1]
                n += 1
        if n and t0 is not None:
            self._observe_hold(lock.site, time.monotonic() - t0)
        return n

    def note_reacquire(self, lock: "TrackedLock", n: int) -> None:
        # restoring after a cv.wait: not a new ordering observation
        st = self._stack()
        now = time.monotonic()
        for _ in range(max(1, n)):
            st.append((lock, now))

    def note_rpc(self, op: str) -> None:
        held = self.held_sites()
        if not held:
            return
        with self._mu:
            if len(self.rpc_violations) < _MAX_VIOLATIONS:
                self.rpc_violations.append({
                    "op": op,
                    "held": held,
                    "thread": threading.current_thread().name,
                })

    # -- graph -------------------------------------------------------------

    def _add_edge(self, a: str, b: str) -> None:
        d = self.edges.get(a)
        if d is not None and b in d:       # racy fast path: reads are safe
            return
        with self._mu:
            d = self.edges.setdefault(a, {})
            if b in d:
                return
            d[b] = threading.current_thread().name
            path = self._path_locked(b, a)
            if path and len(self.cycles) < _MAX_VIOLATIONS:
                self.cycles.append({
                    "edge": (a, b),
                    "cycle": [a, b] + path[1:],
                    "thread": threading.current_thread().name,
                })

    def _path_locked(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS src→dst over edges (caller holds ``_mu``)."""
        stack, seen = [(src, [src])], {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- metrics / reporting ----------------------------------------------

    def _observe_hold(self, site: str, dt: float) -> None:
        if not self._metrics:
            return
        if getattr(self._tls, "in_metric", False):
            return                          # re-entrancy firewall
        self._tls.in_metric = True
        try:
            from ..telemetry import metrics as _m
            _m.histogram("analysis.lock.hold_ms", site=site).observe(
                dt * 1e3)
        except Exception:
            pass
        finally:
            self._tls.in_metric = False

    def report(self) -> dict:
        with self._mu:
            return {
                "sites": len(set(self.edges) |
                             {b for d in self.edges.values() for b in d}),
                "edges": sum(len(d) for d in self.edges.values()),
                "acquisitions": self.acquisitions,
                "cycles": list(self.cycles),
                "rpc_violations": list(self.rpc_violations),
            }

    def assert_clean(self) -> None:
        rep = self.report()
        problems = []
        for c in rep["cycles"]:
            problems.append(f"lock-order cycle {' -> '.join(c['cycle'])} "
                            f"(closed by thread {c['thread']})")
        for r in rep["rpc_violations"]:
            problems.append(f"lock(s) {r['held']} held across RPC boundary "
                            f"'{r['op']}' (thread {r['thread']})")
        if problems:
            raise AssertionError(
                "lockdep: %d violation(s):\n  %s"
                % (len(problems), "\n  ".join(problems)))

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.cycles.clear()
            self.rpc_violations.clear()
            self.acquisitions = 0


class TrackedLock:
    """Wraps a real lock/rlock; reports acquire/release to a LockGraph."""

    def __init__(self, inner, site: str, graph: LockGraph):
        self._inner = inner
        self.site = site
        self._graph = graph

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._graph.note_acquire(self)
        return got

    def release(self) -> None:
        self._graph.note_release(self)
        self._inner.release()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        f = getattr(self._inner, "locked", None)
        return bool(f()) if f is not None else False

    # -- threading.Condition protocol -------------------------------------

    def _is_owned(self) -> bool:
        f = getattr(self._inner, "_is_owned", None)
        if f is not None:
            return f()
        return self._graph.owns(self)

    def _release_save(self):
        f = getattr(self._inner, "_release_save", None)
        if f is not None:
            n = self._graph.note_release_all(self)
            return ("deep", f(), n)
        self._graph.note_release(self)
        self._inner.release()
        return ("flat", None, 1)

    def _acquire_restore(self, saved) -> None:
        kind, state, n = saved
        if kind == "deep":
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._graph.note_reacquire(self, n)

    def _at_fork_reinit(self) -> None:
        f = getattr(self._inner, "_at_fork_reinit", None)
        if f is not None:
            f()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.site} over {self._inner!r}>"


def wrap(lock, site: str, graph: Optional[LockGraph] = None) -> TrackedLock:
    """Wrap an existing lock under an explicit site name (test entry
    point — no global patching involved)."""
    return TrackedLock(lock, site, graph or _state["graph"] or LockGraph())


# ---------------------------------------------------------------------------
# global install

_state = {
    "installed": False,
    "graph": None,
    "saved": None,
}


def enabled() -> bool:
    return os.environ.get("REPRO_LOCKDEP") == "1"


def _wants_tracking(frame, prefixes) -> bool:
    fn = frame.f_code.co_filename
    if any(part in fn for part in _EXCLUDE_PARTS):
        return False
    if prefixes is None:
        return True
    norm = fn.replace(os.sep, "/")
    return any(p in norm for p in prefixes)


def _lock_factory(real, graph: LockGraph, prefixes):
    def factory():
        frame = sys._getframe(1)
        if not _wants_tracking(frame, prefixes):
            return real()
        return TrackedLock(real(), _site_of(frame), graph)
    return factory


def _condition_factory(graph: LockGraph, prefixes):
    def Condition(lock=None):
        if lock is None:
            frame = sys._getframe(1)
            if _wants_tracking(frame, prefixes):
                lock = TrackedLock(_REAL_RLOCK(), _site_of(frame), graph)
        return _REAL_CONDITION(lock) if lock is not None \
            else _REAL_CONDITION()
    return Condition


def _patch_rpc(graph: LockGraph) -> List[Tuple[object, str, object]]:
    """Hook the RPC boundary: entering forward/call/pull/push with a
    tracked lock held is a violation."""
    saved: List[Tuple[object, str, object]] = []

    def hook(owner, name):
        orig = getattr(owner, name, None)
        if orig is None:
            return

        def checked(self, *args, **kwargs):
            graph.note_rpc(f"{owner.__name__}.{name}")
            return orig(self, *args, **kwargs)

        checked.__name__ = name
        saved.append((owner, name, orig))
        setattr(owner, name, checked)

    from ..core import executor as _executor
    from ..core import rpc as _rpc
    hook(_rpc.Handle, "forward")
    for name in ("call", "pull", "push"):
        hook(_executor.Engine, name)
    return saved


def install(graph: Optional[LockGraph] = None,
            prefixes: Optional[Tuple[str, ...]] = ("repro_torch/",)
            ) -> LockGraph:
    """Patch the lock factories + RPC boundary.  Idempotent; returns
    the active graph.  ``prefixes=None`` tracks every creation site
    (excluding the hard exclusions)."""
    if _state["installed"]:
        return _state["graph"]
    g = graph or LockGraph()
    saved_rpc = _patch_rpc(g)
    _state.update(installed=True, graph=g, saved=saved_rpc)
    threading.Lock = _lock_factory(_REAL_LOCK, g, prefixes)
    threading.RLock = _lock_factory(_REAL_RLOCK, g, prefixes)
    threading.Condition = _condition_factory(g, prefixes)
    return g


def uninstall() -> None:
    """Restore the real factories and RPC methods (already-wrapped lock
    instances keep working — they are just no longer created)."""
    if not _state["installed"]:
        return
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    for owner, name, orig in _state["saved"] or []:
        setattr(owner, name, orig)
    _state.update(installed=False, graph=None, saved=None)


def graph() -> Optional[LockGraph]:
    return _state["graph"]


def report() -> dict:
    g = _state["graph"]
    return g.report() if g else {"sites": 0, "edges": 0, "acquisitions": 0,
                                 "cycles": [], "rpc_violations": []}


def assert_clean() -> None:
    g = _state["graph"]
    if g is not None:
        g.assert_clean()
