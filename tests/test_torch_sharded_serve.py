"""Serving on a mesh: ``Model.prefill`` and ``decode_step`` with
``spmd=TensorParallel(...)`` against one process's unsharded ones.

Two runs a module, one a mesh: 4 gloo ranks on the CPU (``torch_ranks``,
120 s limit) on meshes (data 2, model 2) and (data 1, model 4),
reduced configs in f32: qwen1.5-0.5b (dense GQA), granite-moe-3b-a800m
(expert-parallel, dropless), mamba2-1.3b (SSD heads split, the conv
tail made whole), recurrentgemma-9b (RG-LRU channels split, MQA local attention),
paligemma-3b (a VLM's patches and prefix-LM) and seamless-m4t-large-v2
(an encoder and cross K/V split over their heads).  A 12-token prompt
(and a frontend) prefills a cache of 32 positions, split over the model
axis along the sequence, then 8 greedy decode steps, each attending
through ``sp_decode_attention``.  Each rank's prefill and decode logits
(its rows of the batch) are within 1e-5 of the largest entry of the
unsharded ones and its greedy tokens equal theirs.  Two more cases put
the positions over (data, model) with a batch of 1 (``long_500k``'s
rule), and one holds the sharded decode against the JAX reference's
unsharded ``prefill`` / ``decode_step`` on the same weights (the bridge).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.distrib.sharding import block_shape  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

TOL = 1e-5
MESHES = ((2, 2), (1, 4))
ARCHS = ("qwen1.5-0.5b", "granite-moe-3b-a800m", "mamba2-1.3b",
         "recurrentgemma-9b", "paligemma-3b", "seamless-m4t-large-v2")
S, T, STEPS = 12, 32, 8
KV_RULES = {"kv_seq": ("data", "model")}
CASES = {f"{a.split('-')[0]}-{m[0]}x{m[1]}": dict(arch=a, mesh=m, batch=4)
         for a in ARCHS for m in MESHES}
CASES.update({"qwen-kvseq-b1": dict(arch="qwen1.5-0.5b", mesh=(2, 2),
                                    batch=1, rules=KV_RULES),
              "gemma3-kvseq-b1": dict(arch="gemma3-12b", mesh=(2, 2),
                                      batch=1, rules=KV_RULES)})
REF_CASE = "qwen-reference-2x2"


def _inputs(arch, batch, seed):
    cfg = configs.reduced(arch)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, S)).astype(np.int64)}
    out["frontend"] = (rng.standard_normal(
        (batch, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
        if cfg.frontend != "none" else None)
    return out


def _reference():
    """The JAX reference's reduced qwen in f32: its weights (numpy) and
    its unsharded prefill and greedy decode logits and tokens."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import Model as JModel
    from repro.models import unzip
    cfg = jconfigs.reduced("qwen1.5-0.5b").replace(compute_dtype="float32")
    jm = JModel(cfg)
    jp, _ = unzip(jm.init(jax.random.PRNGKey(0)))
    toks = _inputs("qwen1.5-0.5b", 4, 7)["tokens"]
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                               cache_len=T, impl="xla")
    steps, picked = [], []
    nxt = jnp.argmax(logits, -1)
    for i in range(STEPS):
        picked.append(np.asarray(nxt))
        out, cache = jm.decode_step(jp, cache, nxt[:, None].astype(jnp.int32),
                                    jnp.int32(S + i), impl="xla")
        out = out.reshape(out.shape[0], -1)
        steps.append(np.asarray(out))
        nxt = jnp.argmax(out, -1)
    weights = jax.tree_util.tree_map(np.asarray, jp)
    return toks, weights, [np.asarray(logits).reshape(4, -1),
                           np.stack(steps), np.stack(picked, 1)]


@pytest.fixture(scope="module")
def run():
    cases = {}
    for i, (name, c) in enumerate(CASES.items()):
        cases[name] = dict(c, cache_len=T, steps=STEPS,
                           **_inputs(c["arch"], c["batch"], i))
    toks, weights, want = _reference()
    cases[REF_CASE] = dict(arch="qwen1.5-0.5b", mesh=(2, 2), batch=4,
                           tokens=toks, frontend=None, weights=weights,
                           cache_len=T, steps=STEPS)
    # one 4-rank run a mesh, each within the runner's time limit
    out = [{} for _ in range(4)]
    for mesh in MESHES:
        part = {k: c for k, c in cases.items() if c["mesh"] == mesh}
        for rank, got in enumerate(run_ranks(
                "torch_dist_scenarios", "sharded_serve", 4,
                dict(meshes=[mesh], cases=part))):
            out[rank].update(got)
    return cases, out, want


def _rows(whole, got, batch):
    """This rank's rows of the whole batch's prefill logits, decode logits
    (steps first) and tokens."""
    ax = got["batch_axes"]
    n = got["n_batch"]
    i = got["coords"]["data"] if ax else 0
    b = batch // n
    return [whole[0][i * b:(i + 1) * b], whole[1][:, i * b:(i + 1) * b],
            whole[2][i * b:(i + 1) * b]]


def _check(whole, got, batch):
    for name, want, have in zip(("prefill", "decode", "tokens"),
                                _rows(whole, got, batch), got["sharded"]):
        if name == "tokens":
            np.testing.assert_array_equal(have, want)
            continue
        err = float(np.abs(have - want).max())
        top = float(np.abs(want).max())
        assert err <= TOL * top, (name, err, top)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_serving_matches_one_process(run, name):
    cases, out, _ = run
    whole = out[0][name]["whole"]
    for rank in range(4):
        _check(whole, out[rank][name], cases[name]["batch"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_cache_blocks_are_the_layouts(run, name):
    """Each rank's cache stacks are its blocks of the whole cache under
    the layout's specs: K/V split along the positions (and the batch),
    recurrent states along the heads or channels."""
    from repro_torch.models import Model
    from repro_torch.models.moe import padded_experts
    from types import SimpleNamespace
    cases, out, _ = run
    case = cases[name]
    cfg = configs.reduced(case["arch"]).replace(compute_dtype="float32")
    model = (Model(cfg, e_pad=padded_experts(cfg, case["mesh"][1]))
             if cfg.moe.num_experts else Model(cfg))
    mesh = SimpleNamespace(shape=dict(zip(("data", "model"), case["mesh"])))
    got = out[0][name]
    from repro_torch.distrib.sharding import tree_specs
    shapes, axes = model.cache_axes(case["batch"], T)
    rules = dict(case.get("rules") or {}, batch=tuple(got["batch_axes"]))
    specs = tree_specs(shapes, axes, mesh, rules)
    assert set(got["cache"]) == set(shapes)
    for key, t in shapes.items():
        assert got["cache"][key] == block_shape(t.shape, specs[key], mesh)
    if "k" in shapes and not case.get("rules"):
        assert got["cache"]["k"][2] == T // case["mesh"][1]


def test_sharded_decode_matches_the_reference(run):
    """The sharded port on the reference's weights against the JAX
    reference's unsharded prefill and greedy decode (impl "xla")."""
    cases, out, want = run
    for rank in range(4):
        _check(want, out[rank][REF_CASE], 4)
