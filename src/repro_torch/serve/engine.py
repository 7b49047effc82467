"""KV-cache serving engine: continuous batching, chunked prefill and KV
session reuse, ported from ``src/repro/serve/engine.py`` with the same
step semantics, counters and metric names.

A fixed pool of ``n_slots`` sequence slots shares one cache: the
model's stacks of K/V and recurrent states, each with the slot on dim 1
(``Model.cache_specs``).  New requests prefill into a free slot; every
``step()`` decodes *all* slots in lockstep with per-slot positions (the
(B,) ``pos`` decode path) — free and pinned slots included, whose
garbage K/V lands at their own position above anything live, as in the
reference.  Finished slots free at once and the next queued request
takes over.

**Chunked prefill** (``chunk_tokens > 0``): the prompt lands one
fixed-size chunk per ``step()``, interleaved with the decode of every
other slot; the last chunk is padded to the fixed size.  Chunking and
sessions need ``model.supports_chunked_prefill``; for a model with
recurrent layers both are turned off, as in the reference, and
``stats()`` shows ``chunk_tokens`` and ``session_capacity`` 0.

**KV sessions** (``session_cap > 0``): a finished request that carries a
``session_id`` leaves its K/V pinned in its slot.  A follow-up whose
prompt extends the cached history resumes there and prefills only the
suffix, at an offset.  Pins are evicted LRU-first whenever a fresh
request needs a slot or the table exceeds ``session_cap``.

**Frontends** (a VLM's patches, an encoder-decoder's frames): a
request may carry one, (frontend_seq, frontend_dim) f32.  It counts
``frontend_seq`` positions into the prompt's span, prefills whole
(never chunked) and takes no session, as in the reference; decode
starts at position ``len(prompt) + frontend_seq`` for both kinds.  For
an encoder-decoder that is the reference's quirk, mirrored here: its
decoder wrote self-attention K/V only at ``0..len(prompt)-1``, so each
decode step also attends to ``frontend_seq`` zero K/V rows in between.

Where the reference builds new cache arrays, this engine updates the
slot cache in place: the model writes chunk and decode K/V and states
into the cache it is given, and slot gather/scatter are copies into and
out of the slot's ``[:, slot]`` slice of every stack.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from ..models.common import resolve_device
from ..models.transformer import Model
from ..telemetry import metrics as _metrics

_M_PREFIX_HITS = _metrics.counter("serve.engine.prefix_hits")
_M_PREFIX_MISSES = _metrics.counter("serve.engine.prefix_misses")
_M_TOKENS_SAVED = _metrics.counter("serve.engine.prefix_tokens_saved")
_M_EVICTIONS = _metrics.counter("serve.engine.session_evictions")
_G_OCCUPANCY = _metrics.gauge("serve.engine.occupancy")
_G_PINNED = _metrics.gauge("serve.engine.pinned_sessions")

# chunk size used for session *resume* when chunked prefill is otherwise
# disabled (the resume path is built on prefill-at-an-offset)
_RESUME_CHUNK = 32


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int = 32
    temperature: float = 0.0           # 0 = greedy
    eos_id: int = -1                   # -1 = never
    frontend: Optional[np.ndarray] = None  # (F, frontend_dim) f32
    session_id: Optional[str] = None   # KV-session key (None = stateless)
    out_tokens: List[int] = field(default_factory=list)
    done_event: threading.Event = field(default_factory=threading.Event)
    on_token: Optional[Callable[[int, int], None]] = None
    # monotonic stamps: submit(), slot admission (prefill start) and the
    # first emitted token (TTFT = t_first - t_submit)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    _done_cbs: List[Callable[[], None]] = field(default_factory=list)  #: guarded-by _cb_lock
    _cb_lock: threading.Lock = field(default_factory=threading.Lock)

    def add_done_callback(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` when the request completes (at once if it already
        has)."""
        with self._cb_lock:
            if not self.done_event.is_set():
                self._done_cbs.append(cb)
                return
        cb()

    def _fire_done(self) -> None:
        with self._cb_lock:
            cbs, self._done_cbs = self._done_cbs, []
        for cb in cbs:
            try:
                cb()
            except Exception:
                pass       # a failing waiter must not kill the step loop


class ServeEngine:
    def __init__(self, model: Model, params, *, max_len: int = 512,
                 n_slots: int = 4, seed: int = 0, chunk_tokens: int = 0,
                 session_cap: int = 0, cache_dtype=None, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"]["embedding"].device.type != self.device.type:
            raise ValueError(f"params live on "
                             f"{params['embed']['embedding'].device}, the "
                             f"engine on {self.device}")
        self.model = model
        self.params = params
        self.max_len = max_len
        self.n_slots = n_slots
        self.cache_dtype = cache_dtype or torch.bfloat16
        self.cache = model.cache_specs(n_slots, max_len,
                                       dtype=self.cache_dtype,
                                       device=self.device)
        self.pos = np.zeros((n_slots,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.queue: "queue.Queue[Request]" = queue.Queue()
        # set on submit: idle step loops wait on this instead of polling
        self.work = threading.Event()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self._rid = 0  #: guarded-by _lock
        self._lock = threading.Lock()

        chunkable = model.supports_chunked_prefill
        self.chunk = int(chunk_tokens) if (chunk_tokens and chunkable) else 0
        self.session_cap = int(session_cap) if (session_cap
                                                and chunkable) else 0
        # admit-order backlog (step-thread only)
        self._pending: Deque[Request] = deque()
        # slot -> in-progress chunked-prefill state (step-thread only)
        self._prefill: Dict[int, dict] = {}
        # sid -> {"slot", "tokens", "pos"}; iteration order == LRU
        self.sessions: "OrderedDict[str, dict]" = OrderedDict()
        # session bound to each slot: for an *active* request, the sid it
        # will pin on completion; for a free slot, the pinned session
        self.slot_session: List[Optional[str]] = [None] * n_slots
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.session_evictions = 0

    # ------------------------------------------------------------------ slots
    def _scatter_slot(self, cache1: dict, slot: int) -> None:
        """Copy a B=1 cache into the slot cache at ``slot`` (in place).

        A conv tail lands at the start of the slot's rows, as the
        reference's ``dynamic_update_slice`` writes it: a tail of one row
        (a prompt shorter than ``cw - 1`` tokens) overwrites row 0 and
        leaves the slot's other rows as they were.  Every other entry
        must match the slot's shape."""
        for name, src in cache1.items():
            dst = self.cache[name][:, slot]
            if name.endswith("_conv"):
                dst = dst[:, :src.shape[2]]
            dst.copy_(src[:, 0])

    def _gather_slot(self, slot: int) -> dict:
        """A copy of slot ``slot`` as a B=1 cache: the staging cache a
        resumed session's suffix chunks continue into (a copy, because
        the step loop keeps decoding garbage into the slot meanwhile)."""
        return {name: t[:, slot:slot + 1].clone()
                for name, t in self.cache.items()}

    def submit(self, prompt, max_new: int = 32, temperature: float = 0.0,
               eos_id: int = -1, frontend=None, on_token=None,
               session_id=None) -> Request:
        prompt = np.asarray(prompt, np.int32)
        if frontend is None and self.model.is_encdec:
            raise ValueError(f"{self.model.cfg.name} is an encoder-decoder: "
                             f"a request needs its frontend (frames)")
        span = len(prompt) + (self.model.cfg.frontend_seq
                              if frontend is not None else 0)
        if span + max_new > self.max_len:
            raise ValueError(
                f"prompt span {span} + max_new {max_new} exceeds the "
                f"cache length {self.max_len}")
        if frontend is not None:
            frontend = np.asarray(frontend, np.float32)
            session_id = None       # sessions are token-prefix keyed
        with self._lock:
            self._rid += 1
            rid = self._rid
        req = Request(rid, prompt, max_new, temperature, eos_id, frontend,
                      session_id=session_id, on_token=on_token)
        req.t_submit = time.monotonic()
        self.queue.put(req)
        self.work.set()
        return req

    def pending(self) -> int:
        """Requests submitted but not yet placed in a slot."""
        return self.queue.qsize() + len(self._pending)

    def stats(self) -> Dict[str, Any]:
        busy = sum(1 for r in self.slot_req if r is not None)
        pinned = len(self.sessions)
        occupancy = busy / max(self.n_slots, 1)
        _G_OCCUPANCY.set(occupancy)
        _G_PINNED.set(pinned)
        return {"active_slots": busy,
                "n_slots": self.n_slots, "queued": self.pending(),
                "max_len": self.max_len,
                "occupancy": occupancy,
                "prefilling": len(self._prefill),
                "pinned_sessions": pinned,
                "session_capacity": self.session_cap,
                "session_evictions": self.session_evictions,
                "chunk_tokens": self.chunk,
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_tokens_saved": self.prefix_tokens_saved}

    # ---------------------------------------------------------------- sessions
    def _evict(self, sid: str) -> int:
        """Drop a pinned session; returns the slot it freed."""
        st = self.sessions.pop(sid)
        self.slot_session[st["slot"]] = None
        self.session_evictions += 1
        _M_EVICTIONS.inc()
        return st["slot"]

    def _take_slot(self) -> Optional[int]:
        """A slot for a fresh request: truly free first, else evict the
        LRU pinned session; None when every slot is actively decoding."""
        for i, r in enumerate(self.slot_req):
            if r is None and self.slot_session[i] is None:
                return i
        for sid in list(self.sessions):          # OrderedDict: LRU first
            if self.slot_req[self.sessions[sid]["slot"]] is None:
                return self._evict(sid)
        return None

    def _release_slot(self, slot: int) -> None:
        """Free a finished slot; with sessions enabled and a session id
        bound, the K/V stays pinned in the slot under that id."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        sid = self.slot_session[slot]
        self.slot_session[slot] = None
        if sid is None or req is None or self.session_cap <= 0:
            return
        # cache holds positions 0..pos-1 = full prompt + all emitted
        # tokens except the last (its K/V was never written)
        tokens = np.concatenate([
            np.asarray(req.prompt, np.int32),
            np.asarray(req.out_tokens[:-1], np.int32)])
        if len(tokens) != int(self.pos[slot]):
            return
        old = self.sessions.pop(sid, None)
        if old is not None:
            self.slot_session[old["slot"]] = None
        while len(self.sessions) >= self.session_cap:
            self._evict(next(iter(self.sessions)))
        self.sessions[sid] = {"slot": slot, "tokens": tokens,
                              "pos": int(self.pos[slot])}
        self.slot_session[slot] = sid

    # ------------------------------------------------------------------ admit
    def _admit(self):
        while True:
            try:
                self._pending.append(self.queue.get_nowait())
            except queue.Empty:
                break
        while self._pending:
            req = self._pending[0]
            sid = req.session_id if self.session_cap > 0 else None
            st = self.sessions.get(sid) if sid is not None else None
            if st is not None:
                n = st["pos"]
                if (len(req.prompt) > n
                        and np.array_equal(req.prompt[:n], st["tokens"])):
                    # session hit: resume in the pinned slot, prefill
                    # only the suffix at the cached offset
                    self._pending.popleft()
                    slot = st["slot"]
                    self.sessions.pop(sid)       # re-pinned on completion
                    self.prefix_hits += 1
                    self.prefix_tokens_saved += n
                    _M_PREFIX_HITS.inc()
                    _M_TOKENS_SAVED.inc(n)
                    req.t_admit = time.monotonic()
                    self.slot_req[slot] = req
                    self.slot_session[slot] = sid
                    self._start_chunked(slot, req, req.prompt[n:], base=n,
                                        cache1=self._gather_slot(slot))
                    continue
                # stale prefix: the cached K/V is useless for this prompt
                self._evict(sid)
            if sid is not None:
                self.prefix_misses += 1
                _M_PREFIX_MISSES.inc()
            slot = self._take_slot()
            if slot is None:
                return                   # every slot actively decoding
            self._pending.popleft()
            req.t_admit = time.monotonic()
            self.slot_req[slot] = req
            self.slot_session[slot] = sid
            if self.chunk and req.frontend is None:
                self._start_chunked(
                    slot, req, req.prompt, base=0,
                    cache1=self.model.cache_specs(1, self.max_len,
                                                  dtype=self.cache_dtype,
                                                  device=self.device))
            else:
                self._prefill_monolithic(slot, req)

    def _tokens(self, toks) -> torch.Tensor:
        return torch.tensor(np.asarray(toks, np.int32), device=self.device)

    def _prefill_monolithic(self, slot: int, req: Request):
        frontend = None
        if req.frontend is not None:
            frontend = torch.tensor(req.frontend[None], device=self.device)
        logits, cache1 = self.model.prefill(
            self.params, self._tokens(req.prompt[None, :]),
            cache_len=self.max_len, frontend=frontend)
        self._scatter_slot(cache1, slot)
        tok = self._sample(logits[0], req)
        self.pos[slot] = len(req.prompt) + (
            self.model.cfg.frontend_seq if frontend is not None else 0)
        self.last_tok[slot] = tok
        self._emit(req, tok)
        if req.done_event.is_set():
            self._release_slot(slot)

    # ---------------------------------------------------------------- chunked
    def _start_chunked(self, slot: int, req: Request, suffix, *, base: int,
                       cache1):
        """Queue a chunked prefill: ``suffix`` tokens land at absolute
        positions ``base..`` of the B=1 staging cache, one chunk per
        step(), the last chunk padded to the fixed size."""
        C = self.chunk or _RESUME_CHUNK
        toks = np.asarray(suffix, np.int32)
        n = len(toks)
        pad = (-n) % C
        if pad:
            toks = np.concatenate([toks, np.zeros(pad, np.int32)])
        self._prefill[slot] = {"req": req, "cache1": cache1, "toks": toks,
                               "n": n, "off": 0, "base": base}

    def _prefill_step(self, slot: int, st: dict):
        """Advance one chunk; on the final chunk, scatter the staged
        cache into the slot and emit the first sampled token."""
        C = self.chunk or _RESUME_CHUNK
        req = st["req"]
        chunk = self._tokens(st["toks"][st["off"]:st["off"] + C][None, :])
        logits, st["cache1"] = self.model.prefill_chunk(
            self.params, st["cache1"], chunk, st["base"] + st["off"])
        st["off"] += C
        if st["off"] < st["n"]:
            return
        del self._prefill[slot]
        last = st["n"] - 1 - (st["off"] - C)   # last real token, this chunk
        self._scatter_slot(st["cache1"], slot)
        self.pos[slot] = st["base"] + st["n"]
        tok = self._sample(logits[0, last], req)
        self.last_tok[slot] = tok
        self._emit(req, tok)
        if req.done_event.is_set():
            self._release_slot(slot)

    def _sample(self, logits, req: Request) -> int:
        if req.temperature <= 0.0:
            return int(torch.argmax(logits))     # first maximum, as jnp
        probs = torch.softmax(logits.float() / req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self._gen))

    def _emit(self, req: Request, tok: int):
        if not req.out_tokens:
            req.t_first = time.monotonic()
        req.out_tokens.append(tok)
        if req.on_token:
            req.on_token(req.rid, tok)
        if tok == req.eos_id or len(req.out_tokens) >= req.max_new:
            req.done_event.set()
            req._fire_done()

    # ------------------------------------------------------------------ step
    def step(self) -> int:
        """One engine step: admit, advance one prefill chunk per
        prefilling slot, one decode step for all slots; returns #occupied
        slots (decoding + mid-prefill)."""
        self._admit()
        for slot in list(self._prefill):
            self._prefill_step(slot, self._prefill[slot])
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self._prefill]
        if active:
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self._tokens(self.last_tok[:, None]),
                self._tokens(self.pos))
            for i in active:
                req = self.slot_req[i]
                if req.done_event.is_set():
                    self._release_slot(i)
                    continue
                tok = self._sample(logits[i], req)
                self.pos[i] += 1
                self.last_tok[i] = tok
                self._emit(req, tok)
                if req.done_event.is_set():
                    self._release_slot(i)
        return sum(1 for r in self.slot_req if r is not None)

    def drain(self):
        """Run steps until queue and slots are empty (pinned sessions
        hold no slot_req and do not block draining)."""
        while True:
            n = self.step()
            if n == 0 and self.pending() == 0:
                return

    def generate(self, prompts, max_new: int = 32, temperature: float = 0.0,
                 eos_id: int = -1, frontends=None,
                 session_ids=None) -> List[List[int]]:
        reqs = [self.submit(p, max_new, temperature, eos_id,
                            None if frontends is None else frontends[i],
                            session_id=(None if session_ids is None
                                        else session_ids[i]))
                for i, p in enumerate(prompts)]
        self.drain()
        return [r.out_tokens for r in reqs]
