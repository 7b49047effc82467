"""The port's ServeEngine and ServingGateway.

Parity: greedy token streams of the port's engine equal the JAX
``ServeEngine``'s on the same prompts, weights (carried from the
reference's ``Model.init`` through numpy) and session ids — monolithic
prefill, ``chunk_tokens=8``, session resume, stale prefix, continuous
batching over ``n_slots=2``, and a padded last chunk that crosses the
cache end — with an f32 cache and f32 compute; and for the recurrent
models (mamba2, recurrentgemma), whose engines turn chunking and
sessions off, including prompts shorter than the conv tail; and for
paligemma-3b and seamless-m4t-large-v2 with seeded frontends (patches,
frames), whose requests prefill whole.  Then port-side mirrors of the
engine tests of tests/test_serve_sessions.py and of
``test_gateway_tcp_end_to_end``, and a reference client submitting a
frontend to the port's gateway over tcp."""
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


MOE_ARCH = "granite-moe-3b-a800m"
MOE_SCENARIOS = ["monolithic", "chunked", "batching", "resume", "stale"]


@pytest.fixture(scope="module")
def moe_models():
    """Reduced granite-moe on both sides, with the same weights."""
    jm = JModel(jconfigs.reduced(MOE_ARCH).replace(compute_dtype="float32"))
    jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
    tm = Model(configs.reduced(MOE_ARCH).replace(compute_dtype="float32"))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("name", MOE_SCENARIOS)
def test_moe_greedy_streams_match_reference(moe_models, name):
    """The same scenarios through reduced granite-moe, whose every layer
    routes through the MoE router (dropless): token streams equal, slot
    cache within 1e-4 (f32 on both sides)."""
    jm, jp, tm, tp = moe_models
    kw, script = SCENARIOS[name]
    kw = dict({"max_len": 64}, **kw)
    jeng = JServeEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    teng = ServeEngine(tm, tp, cache_dtype=torch.float32, device="cpu", **kw)
    assert script(teng) == script(jeng)
    want = np.stack([np.asarray(jeng.cache["periods"][0]["k"]),
                     np.asarray(jeng.cache["periods"][0]["v"])])
    np.testing.assert_allclose(
        torch.stack([teng.cache["k"], teng.cache["v"]]).numpy(), want,
        rtol=1e-4, atol=1e-4)


RECURRENT_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b"]


def _short_after_long(eng):
    # one slot: a 19-token prompt, then a 2- and a 1-token prompt, whose
    # one-row conv tails land in row 0 of the slot's tail with rows 1-2
    # left as the request before them decoded them
    return (eng.generate([np.arange(1, 20)], max_new=5)
            + eng.generate([np.array([7, 9])], max_new=5)
            + eng.generate([np.array([11])], max_new=5))


# chunk_tokens and session_cap are asked for and turned off by both
# engines: a recurrent layer cannot continue a prefill at an offset
RECURRENT_SCENARIOS = {
    "monolithic": (dict(n_slots=2), _mono),
    "batching": (dict(n_slots=2, chunk_tokens=8), _batching),
    "sessions": (dict(n_slots=2, chunk_tokens=8, session_cap=4), _resume),
    "short-after-long": (dict(n_slots=1), _short_after_long),
}


@pytest.fixture(scope="module")
def recurrent_models():
    """arch -> reduced mamba2 / recurrentgemma on both sides, with the
    same weights, built on first use."""
    made = {}

    def get(arch):
        if arch not in made:
            jm = JModel(jconfigs.reduced(arch).replace(
                compute_dtype="float32"))
            jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
            tm = Model(configs.reduced(arch).replace(
                compute_dtype="float32"))
            tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
            made[arch] = (jm, jp, tm, tp)
        return made[arch]
    return get


@pytest.mark.parametrize("name", list(RECURRENT_SCENARIOS))
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_greedy_streams_match_reference(recurrent_models, arch,
                                                  name):
    """Token streams through reduced mamba2 (SSD layers) and
    recurrentgemma (RG-LRU and local attention layers), then the whole
    slot cache: states, conv tails and K/V, which every step also
    updates for free slots (1e-4: f32 on both sides).  Both engines turn
    chunking and sessions off."""
    from test_torch_model import jstacks
    jm, jp, tm, tp = recurrent_models(arch)
    kw, script = RECURRENT_SCENARIOS[name]
    kw = dict({"max_len": 64}, **kw)
    jeng = JServeEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    teng = ServeEngine(tm, tp, cache_dtype=torch.float32, device="cpu", **kw)
    assert script(teng) == script(jeng)
    for key in ("chunk_tokens", "session_capacity"):
        assert teng.stats()[key] == jeng.stats()[key] == 0
    want = jstacks(tm.kinds, len(tm.cfg.period), jeng.cache)
    assert set(teng.cache) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(teng.cache[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4)


def test_one_row_conv_tail_keeps_the_slots_other_rows(recurrent_models):
    """The slot copy of a prefill's one-row conv tail writes row 0 of
    the slot's tail and nothing else, as ``dynamic_update_slice`` does;
    the recurrent state is replaced whole."""
    _, _, tm, tp = recurrent_models("mamba2-1.3b")
    eng = make_engine(tm, tp, n_slots=2)
    for t in eng.cache.values():
        t.fill_(5.0)
    _, cache1 = tm.prefill(tp, torch.tensor([[7, 9]], dtype=torch.int32),
                           cache_len=64)
    assert cache1["ssd_conv"].shape[2] == 1
    eng._scatter_slot(cache1, 1)
    conv = eng.cache["ssd_conv"]
    assert torch.equal(conv[:, 1, :1], cache1["ssd_conv"][:, 0])
    assert bool((conv[:, 1, 1:] == 5.0).all())
    assert bool((conv[:, 0] == 5.0).all())
    assert torch.equal(eng.cache["ssd_h"][:, 1], cache1["ssd_h"][:, 0])


FRONTEND_ARCHS = ["paligemma-3b", "seamless-m4t-large-v2"]


@pytest.fixture(scope="module")
def frontend_models():
    """arch -> reduced paligemma / seamless on both sides, with the same
    weights, built on first use."""
    made = {}

    def get(arch):
        if arch not in made:
            jm = JModel(jconfigs.reduced(arch).replace(
                compute_dtype="float32"))
            jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
            tm = Model(configs.reduced(arch).replace(
                compute_dtype="float32"))
            tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
            made[arch] = (jm, jp, tm, tp)
        return made[arch]
    return get


def _frontends(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((cfg.frontend_seq, cfg.frontend_dim))
             * 0.1).astype(np.float32) for _ in range(n)]


def _with_frontends(eng):
    # three requests over two slots (continuous batching), then a
    # request whose session id the engine drops
    cfg = eng.model.cfg
    fes = _frontends(cfg, 4)
    out = eng.generate([np.arange(1, 7), np.arange(3, 13), np.arange(2, 7)],
                       max_new=6, frontends=fes[:3])
    out += eng.generate([np.arange(4, 12)], max_new=4, frontends=fes[3:],
                        session_ids=["s"])
    return out + [[eng.stats()["pinned_sessions"]]]


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_greedy_streams_match_reference(frontend_models, arch):
    """Greedy streams of requests with frontends through reduced
    paligemma (patches before the text, the prefix-LM mask) and
    seamless (frames through the encoder, cross attention), then the
    whole slot cache (self and cross K/V; 1e-4, f32 on both sides).
    Chunking and sessions are asked for; both engines turn them off
    (neither model chunks) and a frontend request keeps no session."""
    from test_torch_model import jstacks
    jm, jp, tm, tp = frontend_models(arch)
    kw = dict(max_len=64, n_slots=2, chunk_tokens=8, session_cap=4)
    jeng = JServeEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    teng = ServeEngine(tm, tp, cache_dtype=torch.float32, device="cpu", **kw)
    assert _with_frontends(teng) == _with_frontends(jeng)
    for key in ("chunk_tokens", "session_capacity"):
        assert teng.stats()[key] == jeng.stats()[key] == 0
    want = jstacks(tm.kinds, len(tm.cfg.period), jeng.cache)
    assert set(teng.cache) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(teng.cache[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4)


def test_encdec_decode_position_quirk(frontend_models):
    """The reference's engine starts an encoder-decoder's decode at
    ``len(prompt) + frontend_seq``, though its decoder wrote
    self-attention K/V only at ``0..len(prompt)-1``: each decode step
    attends to ``frontend_seq`` zero K/V rows between them, which weigh
    in the softmax.  The port mirrors it: the same tokens, the same
    empty rows in the slot's cache, the first decode write at
    ``len + F``; and the quirk is real: decode at ``len`` gives other
    logits."""
    jm, jp, tm, tp = frontend_models("seamless-m4t-large-v2")
    cfg = tm.cfg
    prompt, fe = np.arange(1, 9), _frontends(cfg, 1, seed=5)[0]
    jeng = JServeEngine(jm, jp, cache_dtype=jnp.float32, max_len=64,
                        n_slots=1)
    teng = make_engine(tm, tp, n_slots=1)
    got = teng.generate([prompt], max_new=3, frontends=[fe])
    assert got == jeng.generate([prompt], max_new=3, frontends=[fe])
    n, F = len(prompt), cfg.frontend_seq
    k = teng.cache["k"][:, 0]                      # (layers, T, Hkv, D)
    assert bool((k[:, n:n + F] == 0).all())
    assert bool((k[:, n + F].abs() > 0).any())     # the first decode write
    # the same first decode step at position len(prompt) instead
    toks = torch.from_numpy(prompt[None].astype(np.int32))
    fe_t = torch.from_numpy(fe[None])
    tok = torch.tensor([[got[0][0]]], dtype=torch.int32)
    logits = []
    for pos in (n + F, n):
        _, cache = tm.prefill(tp, toks, cache_len=64, frontend=fe_t)
        logits.append(tm.decode_step(tp, cache, tok, pos)[0])
    assert float((logits[0] - logits[1]).abs().max()) > 1e-3


def test_encdec_request_needs_a_frontend(frontend_models):
    """An encoder-decoder request without its frames is refused at
    submit, before it reaches the step loop."""
    _, _, tm, tp = frontend_models("seamless-m4t-large-v2")
    eng = make_engine(tm, tp, n_slots=1)
    with pytest.raises(ValueError, match="needs its frontend"):
        eng.submit(np.arange(1, 5), max_new=2)
    assert eng.pending() == 0
    with pytest.raises(ValueError, match="takes a frontend"):
        tm.prefill(tp, torch.ones((1, 3), dtype=torch.int32))


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


def test_reference_client_submits_a_frontend_over_tcp(frontend_models):
    """A reference client's ``gen.submit`` carrying a frontend (numpy f32
    on the wire) reaches the port's gateway over tcp; the tokens equal
    those of the port's engine given the same frontend directly."""
    from repro.core.executor import Engine as JEngine
    _, _, tm, tp = frontend_models("paligemma-3b")
    fe = _frontends(tm.cfg, 1, seed=7)[0]
    want = make_engine(tm, tp, n_slots=2).generate([[1, 2, 3]], max_new=5,
                                                   frontends=[fe])[0]
    with Engine("tcp://127.0.0.1:0") as srv, \
            JEngine("tcp://127.0.0.1:0") as cli:
        gw = ServingGateway(srv, make_engine(tm, tp, n_slots=2))
        try:
            rid = cli.call(srv.uri, "gen.submit",
                           {"tokens": [1, 2, 3], "max_new": 5,
                            "frontend": fe.astype(np.float64)},
                           timeout=120.0)["rid"]
            res = cli.call(srv.uri, "gen.result",
                           {"rid": rid, "wait": True, "timeout": 60.0},
                           timeout=120.0)
        finally:
            gw.stop()
    assert res["done"] and res["tokens"] == want


def test_gateway_fabric_registration_is_not_ported(models):
    """Fabric registration is ported (the name is historical): a gateway
    given ``registry=`` registers with the port's RegistryService, and
    ``gen.stats`` is routable by service name through a ServicePool;
    ``close()`` deregisters it."""
    from repro_torch.fabric import (RegistryClient, RegistryService,
                                    ServicePool)
    _, _, m, params = models
    with Engine("tcp://127.0.0.1:0") as reg_e, \
            Engine("tcp://127.0.0.1:0") as srv, \
            Engine("tcp://127.0.0.1:0") as cli:
        reg = RegistryService(reg_e)
        gw = ServingGateway(srv, make_engine(m, params, n_slots=2),
                            registry=reg_e.uri, service="gen-port",
                            report_interval=0.1)
        try:
            view = RegistryClient(cli, reg_e.uri).resolve("gen-port")
            uris = [";".join(i["uris"]) for i in view["instances"]]
            assert uris == [srv.uri]
            assert view["instances"][0]["capacity"] == 2
            pool = ServicePool(cli, reg_e.uri, "gen-port")
            st = pool.call("gen.stats", {}, timeout=10.0)
            assert st["n_slots"] == 2 and st["uris"] == srv.uri
        finally:
            gw.close()
        assert RegistryClient(cli, reg_e.uri).resolve(
            "gen-port")["instances"] == []
        reg.close()
