"""The port's attention-family Model against the JAX reference.

Reduced configs in f32 compute; the weights come from the reference's
``Model.init`` and are carried into the port through numpy
(``params_from_numpy``) inside this process.  Logits and KV caches of
``prefill``, ``prefill_chunk`` (offset 0, offset > 0, and a padded chunk
that crosses the cache end, where the reference clamps the write) and
``decode_step`` (scalar and (B,) positions, and a (B,) write past the
cache that the reference drops) must agree to 1e-4 abs/rel: both sides
are f32 on the CPU, with the operations in another order."""
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
# gemma3: local/global layers, qk-norm, GeGLU, GQA, embed scaling
ARCHS = ["qwen1.5-0.5b", "gemma3-12b"] + MOE_ARCHS
# command-r: parallel block; nemotron: squared-ReLU MLP, untied head
PREFILL_ARCHS = ARCHS + ["command-r-35b", "nemotron-4-340b"]
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


def _jkv(jc, plen):
    """The reference's cache as (layers, B, T, Hkv, D) in layer order."""
    out = {}
    for name in ("k", "v"):
        per = [np.asarray(p[name]) for p in jc["periods"]]
        n_scan = per[0].shape[0] if per else 0
        layers = [np.asarray(p[name]) for p in jc.get("prefix", ())]
        layers += [per[pos][j] for j in range(n_scan) for pos in range(plen)]
        layers += [np.asarray(t[name]) for t in jc["trailing"]]
        out[name] = np.stack(layers)
    return out


def _check_cache(pair, tc, jc):
    want = _jkv(jc, len(pair.cfg.period))
    for name in ("k", "v"):
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


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2", "paligemma-3b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(configs.reduced(arch))
