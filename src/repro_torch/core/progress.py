"""Progress / completion-queue model (paper contribution C5).

Mercury's execution model: when an operation completes, the user callback
is *placed onto a completion queue* — it is executed only when the user
calls ``trigger()``. ``progress()`` drives the underlying NA transport.
The split is what enables high concurrency: a dedicated thread can spin
``progress`` while a pool of worker threads drains ``trigger``, or a
single-threaded user can interleave both — both patterns are implemented
in ``executor.py`` on top of this file, unchanged, which is the paper's
point about shim layers.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, Optional, Tuple

from .na.base import NAPlugin
from .types import Callback, CallbackInfo, Ret


class Context:
    """An execution context: one completion queue bound to one NA plugin."""

    def __init__(self, na: NAPlugin):
        self.na = na
        self._cq: Deque[Tuple[Callback, CallbackInfo]] = deque()  #: guarded-by _cq_lock,_cq_cv
        self._cq_lock = threading.Lock()
        self._cq_cv = threading.Condition(self._cq_lock)
        # deadline-tracked operations: (deadline, cancel_fn) — checked in progress
        self._deadlines: list = []  #: guarded-by _deadline_lock
        self._deadline_lock = threading.Lock()

    # -- completion queue ----------------------------------------------------
    def completion_add(self, cb: Optional[Callback], info: CallbackInfo) -> None:
        with self._cq_cv:
            self._cq.append((cb, info))
            self._cq_cv.notify_all()
        # wake a progress() blocked inside the NA plugin
        self.na.interrupt()

    def completion_count(self) -> int:
        with self._cq_lock:
            return len(self._cq)

    # -- deadlines -------------------------------------------------------------
    def add_deadline(self, deadline: float, on_timeout: Callable[[], None]) -> dict:
        entry = {"deadline": deadline, "fire": on_timeout, "armed": True}
        with self._deadline_lock:
            self._deadlines.append(entry)
        return entry

    def disarm(self, entry: dict) -> None:
        entry["armed"] = False

    def _check_deadlines(self) -> None:
        now = time.monotonic()
        fired = []
        with self._deadline_lock:
            keep = []
            for e in self._deadlines:
                if not e["armed"]:
                    continue
                if e["deadline"] <= now:
                    fired.append(e)
                else:
                    keep.append(e)
            self._deadlines = keep
        for e in fired:
            e["fire"]()

    # -- progress / trigger ------------------------------------------------------
    def progress(self, timeout: float = 0.0) -> Ret:
        """Drive the NA transport. Returns SUCCESS once the completion queue
        is non-empty, TIMEOUT otherwise (Mercury HG_Progress semantics)."""
        deadline = time.monotonic() + timeout
        while True:
            self._check_deadlines()
            if self.completion_count():
                return Ret.SUCCESS
            remaining = deadline - time.monotonic()
            step = min(max(remaining, 0.0), 0.05)
            self.na.progress(step)
            if self.completion_count():
                return Ret.SUCCESS
            if time.monotonic() >= deadline:
                return Ret.TIMEOUT

    def trigger(self, max_count: int = 2 ** 31, timeout: float = 0.0) -> int:
        """Execute up to ``max_count`` queued callbacks; returns the number
        actually executed."""
        executed = 0
        deadline = time.monotonic() + timeout
        while executed < max_count:
            with self._cq_cv:
                if not self._cq:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cq_cv.wait(remaining)
                    if not self._cq:
                        break
                cb, info = self._cq.popleft()
            if cb is not None:
                cb(info)
            executed += 1
        return executed

    def progress_trigger(self, timeout: float = 0.1) -> int:
        """Convenience: one progress pass + drain (single-threaded pattern)."""
        self.progress(timeout)
        return self.trigger()
