"""The port's ServeEngine and ServingGateway.

Parity: greedy token streams of the port's engine equal the JAX
``ServeEngine``'s on the same prompts, weights (carried from the
reference's ``Model.init`` through numpy) and session ids — monolithic
prefill, ``chunk_tokens=8``, session resume, stale prefix, continuous
batching over ``n_slots=2``, and a padded last chunk that crosses the
cache end — with an f32 cache and f32 compute.  Then port-side mirrors
of the engine tests of tests/test_serve_sessions.py and of
``test_gateway_tcp_end_to_end``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import unzip  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.executor import Engine  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.services import ServingGateway  # noqa: E402

ARCH = "qwen1.5-0.5b"
CFG = configs.reduced(ARCH).replace(compute_dtype="float32")


@pytest.fixture(scope="module")
def models():
    jm = JModel(jconfigs.reduced(ARCH).replace(compute_dtype="float32"))
    jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
    tm = Model(CFG)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


def make_engine(m, params, **kw):
    # fp32 cache: parity must not hinge on bf16 rounding of cached K/V
    kw.setdefault("cache_dtype", torch.float32)
    kw.setdefault("max_len", 64)
    return ServeEngine(m, params, device="cpu", **kw)


def _follow(prompt, out, extra):
    return np.concatenate([np.asarray(prompt, np.int32),
                           np.asarray(out, np.int32),
                           np.asarray(extra, np.int32)])


# scenario: (engine kwargs, script(engine) -> token streams)
def _mono(eng):
    return eng.generate([np.arange(1, 20)], max_new=8)


def _batching(eng):
    return eng.generate([np.arange(1, 7), np.arange(3, 25), np.arange(2, 12)],
                        max_new=6)


def _resume(eng):
    p = np.arange(1, 21)
    t1 = eng.generate([p], max_new=4, session_ids=["conv"])
    t2 = eng.generate([_follow(p, t1[0], [7, 9])], max_new=4,
                      session_ids=["conv"])
    return t1 + t2 + [[eng.prefix_hits, eng.prefix_tokens_saved]]


def _stale(eng):
    t1 = eng.generate([np.arange(1, 21)], max_new=4, session_ids=["conv"])
    t2 = eng.generate([np.arange(5, 30)], max_new=4, session_ids=["conv"])
    return t1 + t2 + [[eng.prefix_misses, eng.session_evictions]]


def _clamped(eng):
    # 60 prompt tokens in chunks of 32: the padded second chunk covers
    # positions 32..63 of a 62-long cache
    return eng.generate([np.arange(1, 61) % 500 + 1], max_new=2)


SCENARIOS = {
    "monolithic": (dict(n_slots=2), _mono),
    "chunked": (dict(n_slots=2, chunk_tokens=8), _mono),
    "batching": (dict(n_slots=2, chunk_tokens=8), _batching),
    "resume": (dict(n_slots=2, chunk_tokens=8, session_cap=4), _resume),
    "stale": (dict(n_slots=2, chunk_tokens=8, session_cap=4), _stale),
    "clamped": (dict(n_slots=1, chunk_tokens=32, max_len=62), _clamped),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_greedy_streams_match_reference(models, name):
    """Token streams, and the whole slot cache afterwards: the K/V every
    step writes for free and pinned slots at their stale positions is
    part of the reference's semantics too (1e-4: f32 on both sides)."""
    jm, jp, tm, tp = models
    kw, script = SCENARIOS[name]
    kw = dict({"max_len": 64}, **kw)
    jeng = JServeEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    teng = ServeEngine(tm, tp, cache_dtype=torch.float32, device="cpu", **kw)
    assert script(teng) == script(jeng)
    for kv in ("k", "v"):
        np.testing.assert_allclose(teng.cache[kv].numpy(),
                                   np.asarray(jeng.cache["periods"][0][kv]),
                                   rtol=1e-4, atol=1e-4)


def test_greedy_takes_the_first_maximum(models):
    """As jnp.argmax: ties go to the lowest index."""
    _, _, m, params = models
    eng = make_engine(m, params)
    req = eng.submit(np.arange(1, 4), max_new=1)
    assert eng._sample(torch.tensor([0.0, 3.0, 1.0, 3.0]), req) == 1


def test_sampling_is_deterministic_under_a_seed(models):
    _, _, m, params = models
    runs = [make_engine(m, params, seed=s).generate(
        [np.arange(1, 9)], max_new=8, temperature=1.0)[0] for s in (3, 3, 4)]
    assert runs[0] == runs[1]
    assert all(0 <= t < CFG.vocab for t in runs[2])


# ------------------------------------------- mirrors of test_serve_sessions
def test_chunked_prefill_matches_monolithic(models):
    _, _, m, params = models
    prompt = np.arange(1, 20)              # 19 tokens: 3 chunks, pad 5
    want = make_engine(m, params, n_slots=2).generate([prompt], max_new=8)[0]
    got = make_engine(m, params, n_slots=2, chunk_tokens=8).generate(
        [prompt], max_new=8)[0]
    assert got == want


def test_chunked_interleaves_with_decode(models):
    _, _, m, params = models
    p_a, p_b = np.arange(1, 7), np.arange(3, 25)
    alone = make_engine(m, params, n_slots=1, chunk_tokens=8)
    want_a = alone.generate([p_a], max_new=6)[0]
    want_b = alone.generate([p_b], max_new=6)[0]
    eng = make_engine(m, params, n_slots=2, chunk_tokens=8)
    ra = eng.submit(p_a, max_new=6)
    rb = eng.submit(p_b, max_new=6)
    eng.drain()
    assert ra.out_tokens == want_a
    assert rb.out_tokens == want_b


@pytest.mark.parametrize("where", ["first_token", "mid_decode"])
def test_eos_after_chunked_prefill(models, where):
    """EOS sampled from the prefill chunk itself finishes the request at
    once and frees the slot; EOS mid-decode cuts the stream there."""
    _, _, m, params = models
    prompt = np.arange(1, 20)
    toks = make_engine(m, params, n_slots=1, chunk_tokens=8).generate(
        [prompt], max_new=6)[0]
    # mid-decode: the token whose first occurrence is latest
    eos = toks[0] if where == "first_token" else max(set(toks),
                                                     key=toks.index)
    eng = make_engine(m, params, n_slots=1, chunk_tokens=8)
    req = eng.submit(prompt, max_new=6, eos_id=eos)
    eng.drain()
    assert req.out_tokens == toks[:toks.index(eos) + 1]
    assert req.done_event.is_set()
    assert eng.stats()["active_slots"] == 0
    assert eng.generate([prompt], max_new=6)[0] == toks


def _evict_victim(eng):
    """Flood fresh sessions until "conv" is LRU-evicted."""
    for i in range(3):
        eng.generate([np.arange(2 + i, 20 + i)], max_new=3,
                     session_ids=[f"flood{i}"])
    assert "conv" not in eng.sessions


@pytest.mark.parametrize("case", ["resume", "stale", "evicted"])
def test_follow_up_equals_fresh_prefill(models, case):
    """A follow-up turn gives the tokens of a from-scratch prefill whether
    its session resumes (suffix-only prefill), holds a stale prefix
    (evicted, full prefill) or was evicted under slot pressure."""
    _, _, m, params = models
    cap = 2 if case == "evicted" else 4
    eng = make_engine(m, params, n_slots=2, chunk_tokens=8, session_cap=cap)
    prompt = np.arange(1, 21)
    t1 = eng.generate([prompt], max_new=4, session_ids=["conv"])[0]
    if case == "evicted":
        _evict_victim(eng)
    follow = np.arange(5, 30) if case == "stale" else \
        _follow(prompt, t1, [7, 9])
    want = make_engine(m, params, n_slots=2, chunk_tokens=8).generate(
        [follow], max_new=4)[0]
    hits_before = eng.stats()["prefix_hits"]
    assert eng.generate([follow], max_new=4, session_ids=["conv"])[0] == want
    st = eng.stats()
    if case == "resume":
        assert st["prefix_hits"] == 1
        assert st["prefix_tokens_saved"] == len(prompt) + len(t1) - 1
    elif case == "stale":
        assert st["prefix_hits"] == 0
        assert st["prefix_misses"] == 2
        assert st["session_evictions"] == 1
    else:
        assert st["prefix_hits"] == hits_before        # no phantom hit


def test_all_slots_pinned_no_starvation(models):
    _, _, m, params = models
    eng = make_engine(m, params, n_slots=2, chunk_tokens=8, session_cap=4)
    eng.generate([np.arange(1, 10), np.arange(2, 12)], max_new=3,
                 session_ids=["a", "b"])
    st = eng.stats()
    assert st["pinned_sessions"] == 2 and st["active_slots"] == 0
    req = eng.submit(np.arange(4, 18), max_new=3)
    eng.drain()
    assert len(req.out_tokens) == 3
    assert "a" not in eng.sessions and "b" in eng.sessions


def test_drain_with_pinned_sessions_terminates(models):
    _, _, m, params = models
    eng = make_engine(m, params, n_slots=2, chunk_tokens=8, session_cap=4)
    eng.generate([np.arange(1, 10)], max_new=3, session_ids=["keep"])
    eng.drain()
    st = eng.stats()
    assert st["pinned_sessions"] == 1
    assert st["active_slots"] == 0 and st["occupancy"] == 0.0
    assert "keep" in eng.sessions


def test_sessions_disabled_on_unchunkable_model(models, monkeypatch):
    _, _, m, params = models
    monkeypatch.setattr(type(m), "supports_chunked_prefill",
                        property(lambda self: False))
    eng = make_engine(m, params, n_slots=2, chunk_tokens=8, session_cap=4)
    assert eng.chunk == 0 and eng.session_cap == 0
    out = eng.generate([np.arange(1, 8)], max_new=3, session_ids=["x"])[0]
    assert len(out) == 3
    st = eng.stats()
    assert st["pinned_sessions"] == 0
    assert st["prefix_hits"] == 0 and st["prefix_misses"] == 0


# ------------------------------------------------------------------ gateway
class _StubServe:
    def __init__(self, active, queued, pinned):
        self._s = {"active_slots": active, "queued": queued,
                   "pinned_sessions": pinned}

    def stats(self):
        return dict(self._s)


@pytest.mark.parametrize("active,queued,pinned,want", [
    (0, 0, 0, 0.0), (4, 0, 0, 4.0), (0, 0, 4, 2.0), (1, 2, 2, 4.0)])
def test_gateway_load_signal(active, queued, pinned, want):
    """active + queued + half a slot per pinned session."""
    gw = ServingGateway.__new__(ServingGateway)
    gw.serve = _StubServe(active, queued, pinned)
    assert ServingGateway._load(gw) == want


def test_gateway_tcp_end_to_end(models):
    _, _, m, params = models
    with Engine("tcp://127.0.0.1:0") as srv, \
            Engine("tcp://127.0.0.1:0") as cli:
        gw = ServingGateway(srv, make_engine(m, params, n_slots=2))
        try:
            outs = [cli.call(srv.uri, "gen.generate",
                             {"tokens": [1 + i, 2, 3], "max_new": 5},
                             timeout=120.0) for i in range(3)]
            assert all(len(o["tokens"]) == 5 and o["done"] for o in outs)
            rid = cli.call(srv.uri, "gen.submit",
                           {"tokens": [4, 5, 6], "max_new": 4})["rid"]
            tokens = np.asarray([1, 2, 3], np.int32)
            h = cli.expose([tokens])
            try:
                bulk = cli.call(srv.uri, "gen.submit_bulk",
                                {"desc": h.descriptor().to_bytes(),
                                 "count": 3, "max_new": 5}, timeout=120.0)
                res = [cli.call(srv.uri, "gen.result",
                                {"rid": r, "wait": True, "timeout": 60.0},
                                timeout=120.0) for r in (rid, bulk["rid"])]
            finally:
                h.free()
            assert res[0]["done"] and len(res[0]["tokens"]) == 4
            # the bulk-pulled prompt decodes exactly as the eager one
            assert res[1]["tokens"] == outs[0]["tokens"]
            stats = cli.call(srv.uri, "gen.stats", {})
            assert stats["n_slots"] == 2 and stats["admitted"] == 5
        finally:
            gw.stop()


def test_reference_client_reaches_the_port_over_tcp(models):
    """The two RPC stacks speak one wire protocol: a client Engine of the
    reference package calls the port's gateway.  Each stack keeps its own
    process-global registries, so this goes over tcp, not self://."""
    from repro.core.executor import Engine as JEngine
    _, _, m, params = models
    with Engine("tcp://127.0.0.1:0") as srv, \
            JEngine("tcp://127.0.0.1:0") as cli:
        gw = ServingGateway(srv, make_engine(m, params, n_slots=2))
        try:
            out = cli.call(srv.uri, "gen.generate",
                           {"tokens": [1, 2, 3], "max_new": 5,
                            "session_id": "s"}, timeout=120.0)
            assert out["done"] and len(out["tokens"]) == 5
        finally:
            gw.stop()


def test_gateway_fabric_registration_is_not_ported(models):
    _, _, m, params = models
    with Engine("tcp://127.0.0.1:0") as srv:
        with pytest.raises(NotImplementedError, match="fabric"):
            ServingGateway(srv, make_engine(m, params),
                           registry="tcp://127.0.0.1:1")
