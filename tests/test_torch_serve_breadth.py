"""The port's ServeEngine on four more configurations, against the JAX
reference's ServeEngine on the same weights (the reference's
``Model.init``, carried over through numpy).

Reduced gemma3-12b (local and global layers, a window of 32, qk-norm, a
second RoPE base), deepseek-moe-16b (a dense first layer, shared and
routed experts), command-r-35b (the parallel attention/MLP block) and
nemotron-4-340b (the squared-ReLU MLP, GQA, untied tables) through the
scenarios of ``tests/test_torch_serve.py``: monolithic
prefill, ``chunk_tokens=8``, continuous batching over 2 slots, session
resume and a stale prefix.  gemma3 also takes one window-crossing
request: a 60-token prompt in chunks of 8, whose local layers' chunks at
offsets past 32 drop the keys that fall out of the window while the
global layers read them all.  Greedy token streams equal; the whole
slot cache afterwards within 1e-4 (f32 compute and cache on both sides).

Then the dtype those configs are served in on the card: deepseek-moe-16b,
command-r-35b and nemotron-4-340b with ``param_dtype="bfloat16"`` and f32
compute on both sides (the reference's bf16 leaves carried over as
bf16): prefill and 4 greedy decode steps, the logits within 1e-4 of
their largest entry and the greedy tokens equal."""
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
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCHS = ["gemma3-12b", "deepseek-moe-16b", "command-r-35b",
         "nemotron-4-340b"]
WINDOW_ARCH = "gemma3-12b"
BF16_ARCHS = ["deepseek-moe-16b", "command-r-35b", "nemotron-4-340b"]
TOL = 1e-4


@pytest.fixture(scope="module")
def pairs():
    """(arch, param dtype) -> (reference model, its params, port model,
    the same params bridged), reduced, f32 compute, built on first
    use."""
    made = {}

    def get(arch, param_dtype="float32"):
        if (arch, param_dtype) not in made:
            over = dict(compute_dtype="float32", param_dtype=param_dtype)
            jm = JModel(jconfigs.reduced(arch).replace(**over))
            jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
            tm = Model(configs.reduced(arch).replace(**over))
            tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   device="cpu")
            made[arch, param_dtype] = (jm, jp, tm, tp)
        return made[arch, param_dtype]
    return get


def _follow(prompt, out, extra):
    return np.concatenate([np.asarray(prompt, np.int32),
                           np.asarray(out, np.int32),
                           np.asarray(extra, np.int32)])


# scenario: (engine kwargs, script(engine) -> token streams), as
# tests/test_torch_serve.py's
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


def _window(eng):
    # 60 prompt tokens in chunks of 8: the chunks at offsets 32-56 lie
    # past the reduced window of 32
    return eng.generate([np.arange(7, 67) % 500 + 1], max_new=6)


SCENARIOS = {
    "monolithic": (dict(n_slots=2), _mono),
    "chunked": (dict(n_slots=2, chunk_tokens=8), _mono),
    "batching": (dict(n_slots=2, chunk_tokens=8), _batching),
    "resume": (dict(n_slots=2, chunk_tokens=8, session_cap=4), _resume),
    "stale": (dict(n_slots=2, chunk_tokens=8, session_cap=4), _stale),
}
WINDOW = (dict(n_slots=2, chunk_tokens=8, max_len=72), _window)
CASES = ([(arch, name) for arch in ARCHS for name in SCENARIOS]
         + [(WINDOW_ARCH, "window")])


@pytest.mark.parametrize("arch,name", CASES)
def test_greedy_streams_match_reference(pairs, arch, name):
    """Token streams, then the whole slot cache (every attention layer's
    K/V, which each step also writes for free and pinned slots)."""
    from test_torch_model import jstacks
    jm, jp, tm, tp = pairs(arch)
    kw, script = WINDOW if name == "window" else SCENARIOS[name]
    kw = dict({"max_len": 64}, **kw)
    if name == "window":
        assert "local" in tm.kinds and tm.cfg.window == 32
    jeng = JServeEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    teng = ServeEngine(tm, tp, cache_dtype=torch.float32, device="cpu", **kw)
    assert script(teng) == script(jeng)
    want = jstacks(tm.kinds, len(tm.cfg.period), jeng.cache)
    assert set(teng.cache) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(teng.cache[key].numpy(), w, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_weights_match_reference(pairs, arch):
    """bf16 weights, f32 compute: prefill of 2 x 24 tokens and 4 greedy
    decode steps, each step's logits within 1e-4 of their largest entry
    and the greedy tokens equal."""
    jm, jp, tm, tp = pairs(arch, "bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in _leaves(tp))
    S, steps, T = 24, 4, 32
    toks = np.random.default_rng(3).integers(
        1, tm.cfg.vocab, (2, S)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=T,
                        impl="xla")
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), cache_len=T)
    for i in range(steps + 1):
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=f"step {i}")
        nxt = want.argmax(-1).astype(np.int32)
        assert np.array_equal(tl.numpy().argmax(-1), nxt), f"step {i}"
        if i == steps:
            break
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(nxt[:, None]),
                                jnp.int32(S + i), impl="xla")
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt[:, None]),
                                S + i)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
