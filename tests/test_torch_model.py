"""The port's Model against the JAX reference.

Reduced configs in f32 compute; the weights come from the reference's
``Model.init`` and are carried into the port through numpy
(``params_from_numpy``) inside this process.  Logits and caches (K/V,
and the SSD and RG-LRU states and conv tails) of ``prefill``,
``prefill_chunk`` (offset 0, offset > 0, and a padded chunk that crosses
the cache end, where the reference clamps the write) and ``decode_step``
(scalar and (B,) positions, and a (B,) write past the cache that the
reference drops) must agree to 1e-4 abs/rel: both sides are f32 on the
CPU, with the operations in another order.  paligemma-3b (a VLM: seeded
patches before the text, the prefix-LM mask over them) and
seamless-m4t-large-v2 (an encoder-decoder: seeded frames through the
encoder, cross attention in every decoder layer, its K/V in the cache)
are held the same way with their frontends."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import unzip  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402

TOL = 1e-4
# MoE: granite (40 routed experts, top-8 at full width), deepseek (shared
# experts, a dense first layer)
MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
# mamba2: SSD layers only; recurrentgemma: RG-LRU and local attention
# layers (one period of three, two trailing RG-LRU layers)
RECURRENT_ARCHS = ["mamba2-1.3b", "recurrentgemma-9b"]
# gemma3: local/global layers, qk-norm, GeGLU, GQA, embed scaling
ARCHS = ["qwen1.5-0.5b", "gemma3-12b"] + MOE_ARCHS + RECURRENT_ARCHS
# command-r: parallel block; nemotron: squared-ReLU MLP, untied head
PREFILL_ARCHS = ARCHS + ["command-r-35b", "nemotron-4-340b"]
# paligemma: VLM, prefix-LM, MQA; seamless: encoder-decoder, QKV biases
FRONTEND_ARCHS = ["paligemma-3b", "seamless-m4t-large-v2"]
B = 2


class Pair:
    """One arch on both sides, with the same weights."""

    def __init__(self, arch):
        jcfg = jconfigs.reduced(arch).replace(compute_dtype="float32")
        self.cfg = configs.reduced(arch).replace(compute_dtype="float32")
        self.jm = JModel(jcfg)
        self.jp, _ = unzip(self.jm.init(jax.random.PRNGKey(0)))
        self.tm = Model(self.cfg)
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           self.jp),
                                    device="cpu")

    def jcache(self, T):
        c, _ = unzip(self.jm.cache_specs(B, T, dtype=jnp.float32))
        return c

    def tcache(self, T):
        return self.tm.cache_specs(B, T, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    """arch -> Pair, built on first use."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = Pair(arch)
        return made[arch]
    return get


def _toks(n, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def jstacks(kinds, plen, jc):
    """The reference's cache in the port's layout: its per-layer entries,
    in layer order (layer kinds ``kinds``, period length ``plen``),
    stacked per kind ("k"/"v" over the attention layers, "ssd_h",
    "ssd_conv", "rglru_h", "rglru_conv" over the recurrent ones)."""
    per = jc["periods"]
    n_scan = len(next(iter(per[0].values()))) if per else 0
    layers = list(jc.get("prefix", ()))
    layers += [{k: v[j] for k, v in per[pos].items()}
               for j in range(n_scan) for pos in range(plen)]
    layers += list(jc["trailing"])
    out = {}
    for kind, c in zip(kinds, layers):
        for name, v in c.items():
            key = name if kind in ("attn", "local", "global") \
                else f"{kind}_{name}"
            out.setdefault(key, []).append(np.asarray(v))
    return {k: np.stack(v) for k, v in out.items()}


def _check_cache(pair, tc, jc):
    want = jstacks(pair.tm.kinds, len(pair.cfg.period), jc)
    assert set(tc) == set(want)
    for name in want:
        _close(tc[name], want[name])


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_matches_reference(pairs, arch):
    pr = pairs(arch)
    toks = _toks(40, pr.cfg.vocab)
    jl, jc = pr.jm.prefill(pr.jp, {"tokens": jnp.asarray(toks)},
                           cache_len=48, impl="xla")
    tl, tc = pr.tm.prefill(pr.tp, torch.from_numpy(toks), cache_len=48)
    _close(tl, jl)
    _check_cache(pr, tc, jc)


def _chunk_parity(pr, case):
    T = 20 if case == "clamped" else 40
    first = 0 if case == "offset0" else 16
    toks = _toks(first + 8, pr.cfg.vocab, seed=1)
    jc, tc = pr.jcache(T), pr.tcache(T)
    if first:
        _, jc = pr.jm.prefill_chunk(pr.jp, jc, jnp.asarray(toks[:, :first]),
                                    jnp.int32(0))
        _, tc = pr.tm.prefill_chunk(pr.tp, tc, torch.from_numpy(
            toks[:, :first]), 0)
    jl, jc = pr.jm.prefill_chunk(pr.jp, jc, jnp.asarray(toks[:, first:]),
                                 jnp.int32(first))
    tl, tc = pr.tm.prefill_chunk(pr.tp, tc, torch.from_numpy(
        toks[:, first:]), first)
    _close(tl, jl)
    _check_cache(pr, tc, jc)


@pytest.mark.parametrize("case", ["offset0", "offset16", "clamped"])
def test_prefill_chunk_matches_reference(pairs, case):
    """A chunk at offset 0 into an empty cache, one at offset 16 after a
    16-token chunk, and a padded 8-token chunk at offset 16 of a 20-long
    cache: the reference clamps that write to start at 12."""
    _chunk_parity(pairs("qwen1.5-0.5b"), case)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("case", ["offset0", "offset16", "clamped"])
def test_moe_prefill_chunk_matches_reference(pairs, arch, case):
    """The same three chunks through MoE layers (dropless: an 8-token
    chunk routes exactly as the reference's)."""
    _chunk_parity(pairs(arch), case)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pos", ["scalar", "vector", "dropped"])
def test_decode_matches_reference(pairs, arch, pos):
    """Decode after a 36-token prefill: a scalar position, per-row
    positions, and a row whose position is past the cache (its write is
    dropped)."""
    pr = pairs(arch)
    T, S = 40, 36
    toks = _toks(S + 1, pr.cfg.vocab, seed=2)
    p = {"scalar": S, "vector": np.asarray([S, 30], np.int32),
         "dropped": np.asarray([T, S], np.int32)}[pos]
    _, jc = pr.jm.prefill(pr.jp, {"tokens": jnp.asarray(toks[:, :S])},
                          cache_len=T, impl="xla")
    _, tc = pr.tm.prefill(pr.tp, torch.from_numpy(toks[:, :S]), cache_len=T)
    jl, jc = pr.jm.decode_step(pr.jp, jc, jnp.asarray(toks[:, S:]),
                               jnp.asarray(p, jnp.int32), impl="xla")
    tl, tc = pr.tm.decode_step(pr.tp, tc, torch.from_numpy(toks[:, S:]),
                               torch.as_tensor(p, dtype=torch.int32))
    _close(tl, jl)
    _check_cache(pr, tc, jc)


# port-side mirrors of tests/test_models.py
def test_decode_matches_prefill(pairs):
    pr = pairs("qwen1.5-0.5b")
    S, EXT = 48, 4
    toks = torch.from_numpy(_toks(S + EXT, pr.cfg.vocab, seed=3))
    lg, cache = pr.tm.prefill(pr.tp, toks[:, :S], cache_len=S + 8)
    want, _ = pr.tm.prefill(pr.tp, toks, cache_len=S + 8)
    for i in range(EXT):
        lg, cache = pr.tm.decode_step(pr.tp, cache,
                                      toks[:, S + i:S + i + 1], S + i)
    np.testing.assert_allclose(lg.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_vector_pos_decode_matches_scalar(pairs):
    """Continuous-batching (vector pos) decode == lockstep (scalar pos)."""
    pr = pairs("qwen1.5-0.5b")
    S = 32
    toks = torch.from_numpy(_toks(S + 1, pr.cfg.vocab, seed=4))
    _, cache = pr.tm.prefill(pr.tp, toks[:, :S], cache_len=S + 4)
    lg_s, _ = pr.tm.decode_step(pr.tp, {k: v.clone() for k, v in
                                        cache.items()}, toks[:, S:], S)
    lg_v, _ = pr.tm.decode_step(pr.tp, cache, toks[:, S:],
                                torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(lg_v.numpy(), lg_s.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_seeded_init_is_reproducible():
    cfg = configs.reduced("qwen1.5-0.5b")
    a = Model(cfg).init(7, device="cpu")
    b = Model(cfg).init(7, device="cpu")
    c = Model(cfg).init(8, device="cpu")
    assert torch.equal(a["layers"][2]["attn"]["wq"],
                       b["layers"][2]["attn"]["wq"])
    assert not torch.equal(a["layers"][2]["attn"]["wq"],
                           c["layers"][2]["attn"]["wq"])


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_decode_matches_prefill(pairs, arch):
    """Prefill of S tokens then EXT decode steps give the logits and the
    whole cache (states, conv tails and local K/V) of a prefill of
    S + EXT tokens."""
    pr = pairs(arch)
    S, EXT, T = 24, 4, 32
    toks = torch.from_numpy(_toks(S + EXT, pr.cfg.vocab, seed=5))
    lg, cache = pr.tm.prefill(pr.tp, toks[:, :S], cache_len=T)
    want, want_cache = pr.tm.prefill(pr.tp, toks, cache_len=T)
    for i in range(EXT):
        lg, cache = pr.tm.decode_step(pr.tp, cache,
                                      toks[:, S + i:S + i + 1], S + i)
    np.testing.assert_allclose(lg.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)
    assert set(cache) == set(want_cache)
    for name in cache:
        np.testing.assert_allclose(cache[name].numpy(),
                                   want_cache[name].numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
@pytest.mark.parametrize("S", [1, 2, 3])
def test_short_prompt_conv_tail_matches_reference(pairs, arch, S):
    """A prompt under cw - 1 = 3 tokens leaves a one-row conv tail, as
    the reference's ``u[:, S-(cw-1):]`` slices it (S = 2 keeps the last
    row); at 3 tokens the tail is whole."""
    pr = pairs(arch)
    toks = _toks(S, pr.cfg.vocab, seed=6)
    jl, jc = pr.jm.prefill(pr.jp, {"tokens": jnp.asarray(toks)},
                           cache_len=8, impl="xla")
    tl, tc = pr.tm.prefill(pr.tp, torch.from_numpy(toks), cache_len=8)
    _close(tl, jl)
    _check_cache(pr, tc, jc)
    rows = {f"{k}_conv" for k in pr.tm.stack_sizes} & set(tc)
    assert {tc[name].shape[2] for name in rows} == {1 if S < 3 else 3}


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_models_do_not_chunk(pairs, arch):
    """As the reference: no chunked prefill for a recurrent layer."""
    pr = pairs(arch)
    assert not pr.tm.supports_chunked_prefill
    assert not pr.jm.supports_chunked_prefill
    with pytest.raises(ValueError, match="chunked prefill requires"):
        pr.tm.prefill_chunk(pr.tp, pr.tcache(16),
                            torch.from_numpy(_toks(8, pr.cfg.vocab)), 0)


def test_recurrent_state_stays_f32_in_a_bf16_cache():
    """As ``ssd_cache_spec`` / ``rglru_cache_spec``: h is f32 whatever
    the cache dtype; the conv tails and K/V take it."""
    for arch in RECURRENT_ARCHS:
        m = Model(configs.reduced(arch))
        c = m.cache_specs(2, 16, dtype=torch.bfloat16, device="cpu")
        for name, t in c.items():
            want = torch.float32 if name.endswith("_h") else torch.bfloat16
            assert t.dtype == want, (arch, name, t.dtype)
            assert t.shape[1] == 2


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "paligemma-3b"])
def test_unported_families_raise(arch):
    """The two families the port once refused now construct (the name is
    historical): seeded weights with the frontend projection, the
    encoder and the decoder's cross layers for an encoder-decoder; the
    cross K/V stacks in the cache; no chunked prefill, as the
    reference."""
    cfg = configs.reduced(arch)
    m = Model(cfg)
    p = m.init(0, device="cpu")
    assert p["embed"]["frontend_proj"].shape == (cfg.frontend_dim,
                                                 cfg.d_model)
    encdec = cfg.n_enc_layers > 0
    assert m.is_encdec == encdec
    assert ("encoder" in p) == encdec
    assert all(("cross" in layer) == encdec for layer in p["layers"])
    if encdec:
        assert len(p["encoder"]["layers"]) == cfg.n_enc_layers
    c = m.cache_specs(B, 32, dtype=torch.float32, device="cpu")
    want = {"k", "v"} | ({"cross_k", "cross_v"} if encdec else set())
    assert set(c) == want
    if encdec:
        assert c["cross_k"].shape == (cfg.n_layers, B, cfg.frontend_seq,
                                      cfg.n_kv_heads, cfg.hd)
    assert not m.supports_chunked_prefill


def _frontend(cfg, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.frontend_seq, cfg.frontend_dim)) * 0.1).astype(np.float32)


def _span(cfg):
    """Positions the frontend takes before the text: a VLM's patches."""
    return cfg.frontend_seq if cfg.family == "vlm" else 0


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_prefill_matches_reference(pairs, arch):
    """Prefill with a frontend: the logits and the whole cache (the
    patches' and the text's K/V; the encoder-decoder's cross K/V of
    every decoder layer)."""
    pr = pairs(arch)
    toks, fe = _toks(12, pr.cfg.vocab), _frontend(pr.cfg)
    jl, jc = pr.jm.prefill(pr.jp, {"tokens": jnp.asarray(toks),
                                   "frontend": jnp.asarray(fe)},
                           cache_len=48, impl="xla")
    tl, tc = pr.tm.prefill(pr.tp, torch.from_numpy(toks), cache_len=48,
                           frontend=torch.from_numpy(fe))
    _close(tl, jl)
    _check_cache(pr, tc, jc)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
@pytest.mark.parametrize("pos", ["scalar", "vector"])
def test_frontend_decode_matches_reference(pairs, arch, pos):
    """Decode after a prefill with a frontend, at a scalar position and
    at per-row positions: cross attention reads the cache's K/V."""
    pr = pairs(arch)
    S = 12
    at = _span(pr.cfg) + S
    toks, fe = _toks(S + 1, pr.cfg.vocab, seed=2), _frontend(pr.cfg, 1)
    p = at if pos == "scalar" else np.asarray([at, at - 3], np.int32)
    _, jc = pr.jm.prefill(pr.jp, {"tokens": jnp.asarray(toks[:, :S]),
                                  "frontend": jnp.asarray(fe)},
                          cache_len=48, impl="xla")
    _, tc = pr.tm.prefill(pr.tp, torch.from_numpy(toks[:, :S]),
                          cache_len=48, frontend=torch.from_numpy(fe))
    jl, jc = pr.jm.decode_step(pr.jp, jc, jnp.asarray(toks[:, S:]),
                               jnp.asarray(p, jnp.int32), impl="xla")
    tl, tc = pr.tm.decode_step(pr.tp, tc, torch.from_numpy(toks[:, S:]),
                               torch.as_tensor(p, dtype=torch.int32))
    _close(tl, jl)
    _check_cache(pr, tc, jc)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_decode_matches_prefill(pairs, arch):
    """Decode steps after a prefill give a longer prefill's logits (the
    port's own consistency, as tests/test_models.py's)."""
    pr = pairs(arch)
    S, EXT = 10, 3
    toks = torch.from_numpy(_toks(S + EXT, pr.cfg.vocab, seed=3))
    fe = torch.from_numpy(_frontend(pr.cfg, 2))
    lg, cache = pr.tm.prefill(pr.tp, toks[:, :S], cache_len=48, frontend=fe)
    want, _ = pr.tm.prefill(pr.tp, toks, cache_len=48, frontend=fe)
    for i in range(EXT):
        lg, cache = pr.tm.decode_step(pr.tp, cache,
                                      toks[:, S + i:S + i + 1],
                                      _span(pr.cfg) + S + i)
    np.testing.assert_allclose(lg.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_bridge_unstacks_the_encoder_in_layer_order():
    """seamless-m4t-large-v2 at full depth: the reference's
    ``encoder.stack`` (24 layers) comes out as ``encoder.layers`` in
    layer order beside its final norm, and the decoder layers keep their
    cross subtrees."""
    cfg = configs.get("seamless-m4t-large-v2")
    n, e = cfg.n_layers, cfg.n_enc_layers

    def block(idx, cross):
        b = {"norm1": idx, "attn": {"w": idx}}
        if cross:
            b.update(cross={"w": idx}, cross_norm=idx)
        return b
    tree = {"embed": {"embedding": np.zeros((2, 2), np.float32),
                      "frontend_proj": np.zeros((3, 2), np.float32)},
            "periods": (block(np.arange(n), True),), "trailing": (),
            "final_norm": np.zeros(2, np.float32),
            "encoder": {"stack": block(100 + np.arange(e), False),
                        "final_norm": np.full(2, 7.0, np.float32)}}
    p = params_from_numpy(tree, device="cpu")
    assert [int(x["cross"]["w"]) for x in p["layers"]] == list(range(n))
    assert [int(x["attn"]["w"]) for x in p["encoder"]["layers"]] == \
        list(range(100, 100 + e))
    assert float(p["encoder"]["final_norm"][0]) == 7.0
    assert p["embed"]["frontend_proj"].shape == (3, 2)


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_bridge_unstacks_full_depth_in_layer_order(arch):
    """At full depth — mamba2: one period of 48 SSD layers;
    recurrentgemma: 12 periods of (rglru, rglru, local) and 2 trailing
    RG-LRU layers — the reference's stacked periods and trailing layers
    come out as one list in layer order, each with its kind's block."""
    cfg = configs.get(arch)
    kinds = Model(cfg).kinds
    plen = len(cfg.period)
    n_scan, rem = divmod(cfg.n_layers, plen)

    def block(kind, idx):
        key = "attn" if kind in ("attn", "local", "global") else "rec"
        return {"norm1": idx, key: {"w": idx}}
    tree = {"embed": {"embedding": np.zeros((2, 2), np.float32)},
            "periods": tuple(block(kind, np.arange(n_scan) * plen + pos)
                             for pos, kind in enumerate(cfg.period)),
            "trailing": tuple(block(cfg.period[i],
                                    np.asarray(n_scan * plen + i))
                              for i in range(rem)),
            "final_norm": np.zeros(2, np.float32)}
    layers = params_from_numpy(tree, device="cpu")["layers"]
    assert [int(p["norm1"]) for p in layers] == list(range(cfg.n_layers))
    assert [("attn" in p) for p in layers] == \
        [k in ("attn", "local", "global") for k in kinds]
    assert all(int(next(iter(p.get("attn", p.get("rec")).values()))) == i
               for i, p in enumerate(layers))
