"""Tensor-parallel compute in the sharded training step
(``repro_torch.distrib.tensor_parallel``, the layers' ``tp`` arguments,
``GatherFromAxes`` / ``ReduceScatterToAxes`` and the two collective
forms) against the unsharded computations.

One run a module: 4 gloo ranks on the CPU (``torch_ranks``, 120 s limit)
on meshes (data 2, model 2) and (data 1, model 4) run every case below;
the unsharded yardsticks run in this process on the same inputs.

* The collective forms: for blocks split on dim 0, on the last dim (as
  ``wo``), on one dim while another stays split over the model axis,
  over two axes on one dim, and a leaf no axis splits, the direct form
  (all-gather / reduce-scatter calls) and the all-reduce form (the one
  gloo takes for CUDA tensors) give the same blocks bitwise and the same
  sums, both numpy's; ``GatherFromAxes`` (with and without ``same``)
  and ``ReduceScatterToAxes`` forward and backward against numpy.
* Attention on the rank's heads (MHA with QKV biases, GQA, MQA with a
  window, GQA whose key/value heads the model axis does not divide,
  groups cut across ranks, qk-norm, cross attention), the column- and
  row-parallel MLPs (SwiGLU, GeGLU, GELU, squared ReLU), the SSD block
  on the rank's heads (one group; two groups, whole on a model axis of
  2 and one a rank on 4; one rank's channels 30 times the others', so
  that a gated norm over the local channels alone would fail) and the
  RG-LRU block on its channels, f32: the output, the input's gradient
  and every leaf's gradient (split leaves put back together, whole
  leaves on every rank) within 1e-5 of the largest entry of the
  unsharded ones (the key bias's, zero in exact arithmetic, of the input
  gradient's); the SSD and RG-LRU outputs also within 1e-5 of the
  reference's ``ssd_block_apply`` / ``rglru_block_apply`` (``impl="ref"``)
  on the same weights.
* The vocabulary-parallel lookup (bitwise, f32 and bf16 with the embed
  scale) and ``chunked_ce_loss`` (tied and untied tables, softcap,
  z-loss, ``ignore_id`` targets, a padded last chunk): loss and metrics
  at rtol 1e-5 (bf16 1e-4), the hidden states' and the tables'
  gradients within 1e-5 of their largest entry (bf16 2e-2: each rank's
  partial product rounds before the sum).
* 3 AdamW steps of the sharded step against the unsharded step, held to
  ``test_torch_sharded_step.py``'s bounds (loss and gradient norm rtol
  2e-4, every parameter after 1 and 3 steps within 1e-5, stored bytes
  ``bytes_per_device``'s): deepseek-moe-16b (shared expert, dense first
  layer), paligemma-3b (MQA, the VLM frontend), recurrentgemma-9b
  (attention beside tensor-parallel RG-LRU blocks), mamba2-1.3b
  (tensor-parallel SSD blocks and the vocabulary-parallel loss),
  seamless-m4t-large-v2 (cross attention), each on both meshes; and
  qwen1.5-0.5b with a vocabulary of 509, which the model axis does not
  divide (every rank runs the whole-vocabulary loss).
* The gathers' scope, through ``TensorParallel.gathers`` and a
  subclass that watches each gathered leaf: under remat "block" no leaf
  is gathered over the model axis (recurrent blocks included, now that
  the model axis splits them), and when a part gathers, no other layer
  still holds a gathered leaf (the embedding, gathered once, aside).
* Without ranks: a recurrent block that the model axis splits in part
  (``inner`` but not ``ssm_heads``), and SSD heads that would cut a
  group across ranks, refuse; a model axis that splits none of a
  block's dims runs it whole.
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.distrib import collectives as coll  # noqa: E402
from repro_torch.distrib.sharding import (DEFAULT_RULES,  # noqa: E402
                                          abstract_mesh, bytes_per_device,
                                          entry_axes, spec_for)
from repro_torch.distrib.tensor_parallel import TensorParallel  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.common import (chunked_ce_loss,  # noqa: E402
                                       embed_tokens, mlp, mlp_axes,
                                       mlp_params)
from repro_torch.models.rglru_block import (rglru_axes,  # noqa: E402
                                            rglru_block_apply, rglru_params)
from repro_torch.models.ssd_block import (ssd_axes,  # noqa: E402
                                          ssd_block_apply, ssd_params)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402
from repro_torch.train.step import (init_state,  # noqa: E402
                                    init_state_axes, make_train_step)
from torch_dist_scenarios import _step_model  # noqa: E402
from torch_ranks import run_ranks  # noqa: E402

MESHES = ((2, 2), (1, 4))
AXES = ("data", "model")
TOL = 1e-5

# ---- the collective forms
FORMS = {
    "rows": ((8, 6), ("data",), ("data",), ()),
    "last_dim": ((4, 3, 8), (None, None, "data"), ("data",), ()),
    "model_kept": ((4, 6), ("data", "model"), ("data",), ()),
    "two_axes": ((8, 6), (("data", "model"),), ("data", "model"), ()),
    "replicated": ((5,), (), ("data",), ()),
    "same": ((4, 6), ("data", "model"), ("data",), ("model",)),
}

# ---- the layers: (arch, config fields, sub-layer, attention kind)
WIDE = dict(n_heads=12, n_kv_heads=3, head_dim=16)  # groups of 4 cut
LAYERS = {
    "attn-mha-bias": ("qwen1.5-0.5b", {}, "attn", "attn"),
    "attn-gqa": ("granite-moe-3b-a800m", {}, "attn", "attn"),
    "attn-mqa-window": ("recurrentgemma-9b", {}, "attn", "local"),
    "attn-qknorm": ("gemma3-12b", {}, "attn", "global"),
    "attn-cut-groups": ("qwen1.5-0.5b", WIDE, "attn", "attn"),
    "cross": ("seamless-m4t-large-v2", {}, "cross", "attn"),
    "mlp-swiglu": ("qwen1.5-0.5b", {}, "mlp", None),
    "mlp-geglu": ("gemma3-12b", {}, "mlp", None),
    "mlp-gelu": ("seamless-m4t-large-v2", {}, "mlp", None),
    "mlp-relu2": ("nemotron-4-340b", {}, "mlp", None),
    "ssd": ("mamba2-1.3b", {}, "ssd", None),
    "ssd-groups": ("mamba2-1.3b", dict(ssm=dict(ngroups=2)), "ssd", None),
    "ssd-norm": ("mamba2-1.3b", {}, "ssd", "norm"),
    "rglru": ("recurrentgemma-9b", {}, "rglru", None),
}
RECURRENT = {"ssd": (ssd_params, ssd_axes, ssd_block_apply),
             "rglru": (rglru_params, rglru_axes, rglru_block_apply)}
# the recurrent blocks' leaves drawn at a constant (0 or 1), moved off it
OFF_INIT = ("dt_bias", "D", "norm", "conv_b", "a_gate_w", "a_gate_b",
            "i_gate_w", "i_gate_b")
LB, LS = 2, 12

# ---- the vocabulary: config fields, untied head, chunk, z_coef
VOCAB = {
    "tied": (dict(), 5, 1e-4),
    "softcap-z": (dict(logit_softcap=30.0), 4, 1e-2),
    "untied": (dict(tie_embeddings=False), 12, 1e-4),
    "bf16-scaled": (dict(compute_dtype="bfloat16", embed_scale=True), 5,
                    1e-4),
}

# ---- the steps
STEP_ARCHS = ("deepseek-moe-16b", "paligemma-3b", "recurrentgemma-9b",
              "mamba2-1.3b", "seamless-m4t-large-v2")
STEPS = {f"{a.split('-')[0]}-{m[0]}x{m[1]}": (a, m, {})
         for a in STEP_ARCHS for m in MESHES}
STEPS["qwen-v509-2x2"] = ("qwen1.5-0.5b", (2, 2), dict(vocab=509))
OPT = dict(lr=1e-3, warmup=0, decay_steps=10, eps=1e-3)
N_STEPS, SNAPS = 3, (1, 3)
B, S = 8, 16

# ---- the gathers' scope
SCOPE = ("qwen1.5-0.5b", "deepseek-moe-16b", "recurrentgemma-9b",
         "seamless-m4t-large-v2", "mamba2-1.3b")
# parts whose gathered leaves live across layers: the embedding (the
# lookup and the loss) and an encoder's final norm (kept by the norm of
# the memory every decoder layer reads)
KEPT = ("('embed',)", "('encoder', 'final_norm')")


def _mesh_name(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _coords(rank, mesh):
    return {"data": rank // mesh[1], "model": rank % mesh[1]}


def _np_block(x, spec, mesh, coords, axes):
    """numpy's block of ``x`` under ``spec`` over the mesh axes
    ``axes``."""
    for d, entry in enumerate(spec):
        take = [a for a in entry_axes(entry) if a in axes]
        if not take:
            continue
        n = math.prod(mesh[a] for a in take)
        idx = 0
        for a in take:
            idx = idx * mesh[a] + coords[a]
        b = x.shape[d] // n
        x = np.take(x, range(idx * b, (idx + 1) * b), axis=d)
    return x


def _group(rank, mesh, axes):
    """The ranks that differ from ``rank`` only on ``axes``."""
    me = _coords(rank, mesh)
    return [r for r in range(mesh[0] * mesh[1])
            if all(_coords(r, mesh)[a] == me[a] for a in AXES
                   if a not in axes)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _cfg(arch, over):
    """Reduced ``arch`` with ``over`` (its ``ssm`` a dict of SSM fields)."""
    over = dict(over)
    cfg = configs.reduced(arch)
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    return cfg.replace(**over)


def _layer_inputs(name, mesh):
    arch, over, what, kind = LAYERS[name]
    over = dict(over, compute_dtype="float32")
    cfg = _cfg(arch, over)
    gen = torch.Generator().manual_seed(5)
    p = (mlp_params(cfg, gen) if what == "mlp"
         else RECURRENT[what][0](cfg, gen) if what in RECURRENT
         else attn.attn_params(cfg, gen))
    rng = np.random.default_rng(5)
    params = {}
    for key, t in p.items():
        a = t.numpy()
        if key.startswith(("b", "q_norm", "k_norm")) or (
                what in RECURRENT and key in OFF_INIT):
            # biases and norm weights away from their 0 / 1 init
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.3
        params[key] = a
    if kind == "norm":
        # the first quarter of the xs channels (one rank's, or half of
        # one) 30 times the rest: the gated norm's sum of squares differs
        # across ranks
        d_in = params["wx"].shape[1]
        params["wx"] = params["wx"].copy()
        params["wx"][:, :d_in // 4] *= 30.0
    d = cfg.d_model
    case = dict(arch=arch, over=over,
                what=what, kind=kind, mesh=mesh, params=params,
                x=rng.standard_normal((LB, LS, d)).astype(np.float32),
                gy=rng.standard_normal((LB, LS, d)).astype(np.float32))
    if what == "cross":
        case["memory"] = rng.standard_normal(
            (LB, cfg.frontend_seq, d)).astype(np.float32)
    return case


def _vocab_inputs(name, mesh):
    over, chunk, z_coef = VOCAB[name]
    over = dict(dict(compute_dtype="float32"), **over)
    cfg = configs.reduced("qwen1.5-0.5b").replace(**over)
    rng = np.random.default_rng(7)
    V, d = cfg.vocab, cfg.d_model
    targets = rng.integers(0, V, (LB, LS))
    targets[0, :3] = -1
    targets[1, -2:] = -1
    case = dict(arch="qwen1.5-0.5b", over=over, mesh=mesh, chunk=chunk,
                z_coef=z_coef,
                table=(rng.standard_normal((V, d)) * 0.3).astype(np.float32),
                h=rng.standard_normal((LB, LS, d)).astype(np.float32),
                targets=targets.astype(np.int64),
                tokens=rng.integers(0, V, (LB, LS)).astype(np.int64),
                gy=rng.standard_normal((LB, LS, d)).astype(np.float32))
    if not cfg.tie_embeddings:
        case["head"] = (rng.standard_normal((d, V)) * 0.3).astype(
            np.float32)
    return case


def _batches(cfg, seed=0, n=N_STEPS, b=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (b, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.frontend != "none":
            batch["frontend"] = (rng.standard_normal(
                (b, cfg.frontend_seq, cfg.frontend_dim)) * 0.1).astype(
                    np.float32)
        if cfg.family == "vlm":
            batch["targets"] = np.concatenate(
                [np.full((b, cfg.frontend_seq), -1, np.int32),
                 batch["targets"]], axis=1)
        out.append(batch)
    return out


def _args():
    rng = np.random.default_rng(3)
    forms = {}
    for name, (shape, spec, axes, same) in FORMS.items():
        forms[name] = dict(mesh=(2, 2), spec=spec, axes=axes, same=same,
                           x=rng.standard_normal(shape).astype(np.float32),
                           g=rng.standard_normal((4,) + shape).astype(
                               np.float32))
    forms["model4"] = dict(mesh=(1, 4), spec=(None, "model"),
                           axes=("model",), same=(),
                           x=rng.standard_normal((3, 8)).astype(np.float32),
                           g=rng.standard_normal((4, 3, 8)).astype(
                               np.float32))
    layers = {f"{n}@{_mesh_name(m)}": _layer_inputs(n, m)
              for n in LAYERS for m in MESHES}
    vocab = {f"{n}@{_mesh_name(m)}": _vocab_inputs(n, m)
             for n in VOCAB for m in MESHES}
    steps = {}
    for name, (arch, mesh, over) in STEPS.items():
        cfg = configs.reduced(arch).replace(**over)
        steps[name] = dict(arch=arch, mesh=mesh, over=over, opt=OPT,
                           remat="block", snap=SNAPS, batches=_batches(cfg))
    scope = {a: dict(arch=a, mesh=(2, 2),
                     batch=_batches(configs.reduced(a), seed=4, n=1,
                                    b=4)[0])
             for a in SCOPE}
    return dict(meshes=MESHES, forms=forms, layers=layers, vocab=vocab,
                steps=steps, scope=scope)


@pytest.fixture(scope="module")
def run():
    args = _args()
    return args, run_ranks("torch_dist_scenarios", "tensor_parallel", 4,
                           args)


# ---------------------------------------------------------------------------
# the collective forms
# ---------------------------------------------------------------------------
def test_form_follows_backend_and_device(run):
    cpu = torch.zeros(1)
    cuda = SimpleNamespace(is_cuda=True)       # a CUDA tensor's device flag
    assert coll.collective_form(SimpleNamespace(backend="gloo"), cpu) \
        == "direct"
    assert coll.collective_form(SimpleNamespace(backend="nccl"), cuda) \
        == "direct"
    assert coll.collective_form(SimpleNamespace(backend="gloo"), cuda) \
        == "all_reduce"
    _, ranks = run
    assert {r["forms"][n]["form"] for r in ranks for n in FORMS} \
        == {"direct"}


@pytest.mark.parametrize("name", sorted(FORMS) + ["model4"])
def test_both_forms_give_the_same_blocks_and_sums(run, name):
    args, ranks = run
    case = args["forms"][name]
    mesh = dict(zip(AXES, case["mesh"]))
    spec, axes = case["spec"], case["axes"]
    others = tuple(a for a in AXES if a not in axes)
    for rank, res in enumerate(ranks):
        got = res["forms"][name]
        c = _coords(rank, case["mesh"])
        want = _np_block(case["x"], spec, mesh, c, others)
        assert np.array_equal(got["gather/direct"], want)
        assert np.array_equal(got["gather/all_reduce"], want)
        total = sum(case["g"][q] for q in _group(rank, case["mesh"], axes))
        want = _np_block(total, spec, mesh, c, AXES)
        np.testing.assert_allclose(got["scatter/direct"], want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["scatter/all_reduce"],
                                   got["scatter/direct"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", sorted(FORMS) + ["model4"])
def test_gather_and_reduce_scatter_rules(run, name):
    """GatherFromAxes: forward the block whole over ``axes`` + ``same``;
    backward the gradient summed over ``axes`` only, this rank's block
    kept.  ReduceScatterToAxes: forward the summed block; backward the
    block's gradient gathered."""
    args, ranks = run
    case = args["forms"][name]
    mesh = dict(zip(AXES, case["mesh"]))
    spec, axes, same = case["spec"], case["axes"], tuple(case["same"])
    for rank, res in enumerate(ranks):
        c = _coords(rank, case["mesh"])
        y, dx = res["forms"][name]["gather_fn"]
        keep = tuple(a for a in AXES if a not in axes + same)
        assert np.array_equal(y, _np_block(case["x"], spec, mesh, c, keep))
        total = sum(case["g"][q] for q in _group(rank, case["mesh"], axes))
        np.testing.assert_allclose(dx, _np_block(total, spec, mesh, c, AXES),
                                   rtol=1e-6, atol=1e-6)
        if same:
            continue
        w, dz = res["forms"][name]["scatter_fn"]
        np.testing.assert_allclose(w, _np_block(total, spec, mesh, c, AXES),
                                   rtol=1e-6, atol=1e-6)
        others = tuple(a for a in AXES if a not in axes)
        assert np.array_equal(dz, _np_block(case["x"], spec, mesh, c,
                                            others))


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _unsharded_layer(case):
    cfg = _cfg(case["arch"], case["over"])
    p = {k: torch.from_numpy(v).requires_grad_()
         for k, v in case["params"].items()}
    x = torch.from_numpy(case["x"]).requires_grad_()
    if case["what"] in RECURRENT:
        y = RECURRENT[case["what"]][2](cfg, p, x)[0]
    elif case["what"] == "mlp":
        y = mlp(cfg, p, x)
    elif case["what"] == "cross":
        mem = torch.from_numpy(case["memory"]).requires_grad_()
        y = attn.cross_attn(cfg, p, x, *attn.cross_kv(cfg, p, mem))
    else:
        y = attn.attn_train(cfg, p, x, kind=case["kind"])
    (y * torch.from_numpy(case["gy"])).sum().backward()
    out = dict(y=_np(y), dx=_np(x.grad),
               grads={k: _np(v.grad) for k, v in p.items()})
    if case["what"] == "cross":
        out["dmem"] = _np(mem.grad)
    return cfg, out


def _put_together(name, leaf_axes, want_shape, ranks, key, mesh, group):
    """A leaf's gradient from the ranks: its model-axis blocks joined
    where the resolver splits it over the model axis, else every rank's
    own (each must be the whole gradient)."""
    spec = spec_for(want_shape, leaf_axes, dict(zip(AXES, mesh)),
                    DEFAULT_RULES)
    dims = [d for d, e in enumerate(spec) if "model" in entry_axes(e)]
    got = [r["layers"][name]["grads"][key] for r in ranks]
    if not dims:
        return got
    return [np.concatenate([got[q] for q in group], axis=dims[0])]


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_name)
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_unsharded(run, layer, mesh):
    args, ranks = run
    name = f"{layer}@{_mesh_name(mesh)}"
    case = args["layers"][name]
    cfg, want = _unsharded_layer(case)
    axes_tree = (mlp_axes(cfg) if case["what"] == "mlp"
                 else RECURRENT[case["what"]][1](cfg)
                 if case["what"] in RECURRENT else attn.attn_axes(cfg))
    row = [r for r in range(4) if _coords(r, mesh)["data"] == 0]
    for res in ranks:
        got = res["layers"][name]
        assert _rel(got["y"], want["y"]) <= TOL
        assert _rel(got["dx"], want["dx"]) <= TOL
        if "dmem" in want:
            assert _rel(got["dmem"], want["dmem"]) <= TOL
    if case["what"] in RECURRENT:
        ref = _reference_block(case)
        assert _rel(want["y"], ref) <= TOL
        for res in ranks:
            assert _rel(res["layers"][name]["y"], ref) <= TOL
    for key, g in want["grads"].items():
        # a key bias adds one logit to every key a query sees: its
        # gradient is zero in exact arithmetic, both sides' noise held
        # against the input gradient's largest entry
        scale = (np.abs(want["dx"]).max() if key == "bk"
                 else np.abs(g).max())
        for joined in _put_together(name, axes_tree[key], g.shape, ranks,
                                    key, mesh, row):
            assert np.abs(joined - g).max() <= TOL * scale, key


def _reference_block(case):
    """The reference's SSD or RG-LRU block (its sequential oracle) on the
    case's weights and input."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import rglru_block, ssd_block
    over = dict(case["over"])
    cfg = ref_configs.reduced(case["arch"])
    if "ssm" in over:
        over["ssm"] = dataclasses.replace(cfg.ssm, **over["ssm"])
    cfg = cfg.replace(**over)
    apply = (ssd_block.ssd_block_apply if case["what"] == "ssd"
             else rglru_block.rglru_block_apply)
    y, _ = apply(cfg, {k: jnp.asarray(v) for k, v in case["params"].items()},
                 jnp.asarray(case["x"]), impl="ref")
    return np.asarray(y)


def test_kv_heads_the_model_axis_does_not_divide_are_whole():
    """granite's 2 key/value heads on a model axis of 4, recurrentgemma's
    and paligemma's 1, and 3 heads on 2 or 4: the resolver leaves them
    whole, so each rank projects the heads its queries read."""
    for arch, over, n in (("granite-moe-3b-a800m", {}, 4),
                          ("recurrentgemma-9b", {}, 2),
                          ("paligemma-3b", {}, 4),
                          ("qwen1.5-0.5b", WIDE, 2),
                          ("qwen1.5-0.5b", WIDE, 4)):
        cfg = configs.reduced(arch).replace(**over)
        mesh = abstract_mesh((1, n), AXES)
        wq = spec_for((cfg.d_model, cfg.n_heads, cfg.hd),
                      attn.attn_axes(cfg)["wq"], mesh, DEFAULT_RULES)
        wk = spec_for((cfg.d_model, cfg.n_kv_heads, cfg.hd),
                      attn.attn_axes(cfg)["wk"], mesh, DEFAULT_RULES)
        assert wq == (None, "model") and wk == (), (arch, n)


# ---------------------------------------------------------------------------
# the vocabulary
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_name)
@pytest.mark.parametrize("vocab", sorted(VOCAB))
def test_vocabulary_parallel_lookup_and_loss(run, vocab, mesh):
    args, ranks = run
    name = f"{vocab}@{_mesh_name(mesh)}"
    case = args["vocab"][name]
    cfg = configs.reduced(case["arch"]).replace(**case["over"])
    p = {"embedding": torch.from_numpy(case["table"]).requires_grad_()}
    if "head" in case:
        p["head"] = torch.from_numpy(case["head"]).requires_grad_()
    h = torch.from_numpy(case["h"]).requires_grad_()
    loss, met = chunked_ce_loss(cfg, p, h, torch.from_numpy(case["targets"]),
                                chunk=case["chunk"], z_coef=case["z_coef"])
    loss.backward()
    loss = loss.detach()
    look = torch.from_numpy(case["table"]).requires_grad_()
    emb = embed_tokens(cfg, {"embedding": look},
                       torch.from_numpy(case["tokens"]))
    (emb.float() * torch.from_numpy(case["gy"])).sum().backward()
    bf16 = cfg.compute_dtype == "bfloat16"
    rtol = 1e-4 if bf16 else 1e-5
    # bf16: each rank's partial product rounds once before the sum
    gtol = 2e-2 if bf16 else TOL
    row = [r for r in range(4) if _coords(r, mesh)["data"] == 0]
    for res in ranks:
        got = res["vocab"][name]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=rtol)
        np.testing.assert_allclose(got["ce"], float(met["ce"]), rtol=rtol)
        np.testing.assert_allclose(got["z"], float(met["z_loss"]),
                                   rtol=rtol)
        assert got["tokens"] == int(met["tokens"])
        assert _rel(got["dh"], _np(h.grad)) <= gtol
        assert np.array_equal(got["emb"], _np(emb))      # the rows exact
    # the loss reads the head where the table is untied
    used = "head" if "head" in p else "embedding"
    assert set(ranks[0]["vocab"][name]["grads"]) == {used}
    joined = np.concatenate([ranks[q]["vocab"][name]["grads"][used]
                             for q in row], axis=0 if used == "embedding"
                            else 1)
    assert _rel(joined, _np(p[used].grad)) <= gtol
    demb = np.concatenate([ranks[q]["vocab"][name]["demb"] for q in row])
    assert _rel(demb, _np(look.grad)) <= TOL


def test_vocabulary_that_does_not_split_runs_whole():
    """A vocabulary the model axis does not divide (granite's 49,155 on
    2; 509 here) leaves the embedding whole: no split, the loss whole on
    every rank of the model axis."""
    mesh = SimpleNamespace(shape={"data": 2, "model": 2},
                           coords={"data": 0, "model": 0})
    for vocab, split in ((509, False), (512, True)):
        model = Model(configs.reduced("qwen1.5-0.5b").replace(vocab=vocab))
        tp = TensorParallel(model, mesh, ("data",), "model")
        assert (tp.split(("embed",)) is not None) == split
        assert tp.split(("layers", 0, "attn")) is not None
        assert tp.split(("layers", 0, "mlp")) is not None
    assert configs.get("granite-moe-3b-a800m").vocab % 2


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def unsharded(run):
    args, _ = run
    out = {}
    for name, case in args["steps"].items():
        model = _step_model(case["arch"], case["mesh"], case["over"])
        ocfg = optim.OptConfig(**OPT)
        state = init_state(model, ocfg, 0, device="cpu")
        step = make_train_step(model, ocfg, ParallelConfig(remat="block"))
        losses, snaps = [], {}
        for i, batch in enumerate(case["batches"]):
            state, met = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
            losses.append({k: float(met[k]) for k in ("loss", "grad_norm")})
            if i + 1 in SNAPS:
                snaps[i + 1] = [t.detach().clone().numpy()
                                for t in leaves(state["params"])]
        out[name] = (losses, snaps)
    return out


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_loss_matches_unsharded(run, unsharded, name):
    _, ranks = run
    want, _ = unsharded[name]
    for res in ranks:
        for i, (got, w) in enumerate(zip(res["steps"][name]["losses"],
                                         want)):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=2e-4,
                                       err_msg=f"step {i + 1}")
            np.testing.assert_allclose(got["grad_norm"], w["grad_norm"],
                                       rtol=2e-4, err_msg=f"step {i + 1}")
            assert got["tokens"] == B * S


@pytest.mark.parametrize("step", SNAPS)
@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_params_match_unsharded(run, unsharded, name, step):
    _, ranks = run
    _, want = unsharded[name]
    got = ranks[0]["steps"][name]["snaps"][step]
    assert len(got) == len(want[step])
    worst = max(float(np.abs(g - w).max()) for g, w in
                zip(got, want[step]))
    assert worst <= 1e-5, worst


@pytest.mark.parametrize("name", sorted(STEPS))
def test_step_stores_bytes_per_device(run, name):
    args, ranks = run
    case = args["steps"][name]
    model = _step_model(case["arch"], case["mesh"], case["over"])
    shapes, axes = init_state_axes(model, optim.OptConfig(**OPT))
    want = bytes_per_device(shapes, axes, abstract_mesh(case["mesh"], AXES))
    assert [r["steps"][name]["stored"]["bytes"] for r in ranks] \
        == [want] * 4


# ---------------------------------------------------------------------------
# the gathers' scope
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SCOPE)
def test_dense_leaves_are_gathered_over_the_data_axis_only(run, arch):
    _, ranks = run
    for res in ranks:
        gathers = res["scope"][arch]["gathers"]
        assert gathers, "nothing gathered"
        for key, n in gathers.items():
            sub, axes = key.split("|")
            assert n > 0
            assert axes == "data", key
        subs = {k.split("|")[0] for k in gathers}
        assert {"embed", "norm1"} <= subs
        assert ("rec" in subs) == (arch in ("recurrentgemma-9b",
                                             "mamba2-1.3b"))


@pytest.mark.parametrize("arch", SCOPE)
def test_one_layer_of_gathered_leaves_at_a_time(run, arch):
    _, ranks = run
    for res in ranks:
        got = res["scope"][arch]
        assert got["n_gathers"] > 0
        late = [w for w in got["others"] if set(w) - set(KEPT)]
        assert not late, late[:5]


# ---------------------------------------------------------------------------
# recurrent blocks the model axis splits in part, or not at all
# ---------------------------------------------------------------------------
def _layout(cfg, model_axis):
    mesh = SimpleNamespace(shape={"data": 1, "model": model_axis},
                           coords={"data": 0, "model": 0})
    return TensorParallel(Model(cfg), mesh, ("data",), "model")


def test_a_partial_split_of_a_recurrent_block_refuses():
    """mamba2 with heads of 64 on a model axis of 4: ``inner`` (128)
    splits, ``ssm_heads`` (2) does not."""
    cfg = _cfg("mamba2-1.3b", dict(ssm=dict(head_dim=64)))
    with pytest.raises(ValueError, match=r"splits .*wz\[inner\].* but not "
                       r".*wdt\[ssm_heads\]"):
        _layout(cfg, 4)
    # on 2 both split: the block runs in tensor parallel
    assert _layout(cfg, 2).split(("layers", 0, "rec")) is not None


def test_ssd_heads_that_cut_a_group_refuse():
    """24 heads in 12 groups of 2 on a model axis of 8: 3 heads a rank
    read parts of two groups."""
    cfg = _cfg("mamba2-1.3b", dict(d_model=192, ssm=dict(ngroups=12)))
    with pytest.raises(ValueError, match="groups"):
        _layout(cfg, 8)
    assert _layout(cfg, 4).split(("layers", 0, "rec")) is not None


def test_a_block_the_model_axis_does_not_split_runs_whole():
    """An RG-LRU width of 66 does not divide by 4: every leaf of the block
    whole over the model axis, gathered over it (``same``)."""
    cfg = _cfg("recurrentgemma-9b", {}).replace(
        rglru=dataclasses.replace(configs.reduced(
            "recurrentgemma-9b").rglru, lru_width=66))
    tp = _layout(cfg, 4)
    assert tp.split(("layers", 0, "rec")) is None
    assert tp.split(("layers", 0, "mlp")) is not None
