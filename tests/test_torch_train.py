"""The port's training plane against the JAX reference, on the CPU.

Reduced qwen1.5-0.5b, granite-moe-3b-a800m, mamba2-1.3b and
recurrentgemma-9b in f32 compute, the same weights on both sides (the
reference's ``Model.init`` carried over by ``params_from_numpy``) and the
same numpy batches:

- ``Model.loss_fn``'s loss, ``ce``, ``z_loss`` and the MoE aux losses
  (``moe_lb``, ``moe_z``; granite's layers drop over capacity) and every
  gradient leaf against ``jax.value_and_grad`` of the reference's
  ``loss_fn(impl=JIMPL[arch], remat="none")``, with the port's ``remat``
  "none" and "block": the loss and metrics to 1e-5 relative, each leaf to
  1e-4 of its largest entry (f32 on both sides, summed in another order;
  the router's, the SSD's and the RG-LRU's backwards are their plain
  versions here; recurrentgemma also trains its windowed MQA layers, the
  tied embedding with its scale, the logit softcap and the GeGLU MLP);
- ``train.optim`` against the reference's ``optim``, mirroring
  ``tests/test_optim.py``: the schedule, an AdamW and an Adafactor
  update, the clip and the state dtype;
- 5-step AdamW trajectories (the four models) and an Adafactor one
  (qwen) against the reference's jitted ``make_train_step``: the loss
  and gradient norm at every step, every parameter leaf after the last;
- microbatches 4 against 1 and against the reference's microbatches 4
  (the loss, the gradient norm and AdamW's m, which holds the mean
  gradient), the checkpoint restart determinism of
  ``tests/test_serve_and_train.py`` through the port's
  ``CheckpointClient``, and the launcher on the CPU (qwen, mamba2 and
  recurrentgemma);
- two runs of reduced recurrentgemma's gradients are bitwise equal;
- reduced paligemma-3b (seeded patches before the text under the
  prefix-LM mask, the targets padded with -1 over them) and
  seamless-m4t-large-v2 (seeded frames through the encoder, cross
  attention in every decoder layer) the same way: the loss, every
  gradient leaf (the frontend projection's and the encoder's too), the
  5-step AdamW trajectory (the encoder's stacked leaves decay as the
  reference's) and the launcher.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ParallelConfig as JParallelConfig  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import unzip  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro.train.step import init_state as jinit_state  # noqa: E402
from repro.train.step import make_train_step as jmake_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core.executor import Engine  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import Model, params_from_numpy  # noqa: E402
from repro_torch.services import (CheckpointClient,  # noqa: E402
                                  CheckpointServer)
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.optim import leaves, tree_map  # noqa: E402
from repro_torch.train.step import (init_state, loss_and_grads,  # noqa: E402
                                    make_train_step, stack_groups)

ARCH = "qwen1.5-0.5b"
B, S = 4, 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(tree):
    """A reference tree (params or gradients) as the port's tree."""
    return params_from_numpy(_np_tree(tree), device="cpu")


def _batch(seed, vocab, b=B, s=S, cfg=None):
    """Seeded tokens and targets; for a ``cfg`` with a frontend also its
    seeded ``frontend``, and a VLM's targets padded with -1 over the
    patches, as the launchers pad them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg is not None and cfg.frontend != "none":
        batch["frontend"] = (rng.standard_normal(
            (b, cfg.frontend_seq, cfg.frontend_dim)) * 0.1).astype(
                np.float32)
    if cfg is not None and cfg.family == "vlm":
        batch["targets"] = np.concatenate(
            [np.full((b, cfg.frontend_seq), -1, np.int32),
             batch["targets"]], axis=1)
    return batch


def _span(cfg):
    """Target positions before the text: a VLM's patches."""
    return cfg.frontend_seq if cfg.family == "vlm" else 0


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# The reference's init folds each parameter's path into its key with
# Python's ``hash`` (``src/repro/models/common.py``), so a process draws
# weights that depend on its ``PYTHONHASHSEED``.  The weights are drawn
# in a subprocess under a fixed hash seed, so every run and every test
# worker holds the same ones.
_REFERENCE_INIT = """
import sys
import jax
import numpy as np
from repro import configs
from repro.models import Model, unzip
cfg = configs.reduced(sys.argv[1]).replace(compute_dtype="float32")
params, _ = unzip(Model(cfg).init(jax.random.PRNGKey(0)))
np.savez(sys.argv[2], *[np.asarray(x)
                        for x in jax.tree_util.tree_leaves(params)])
"""


def _reference_params(jm, arch):
    """The reference's seeded parameters of ``jm`` (the reduced ``arch``
    in f32 compute), drawn under ``PYTHONHASHSEED=0``."""
    import os
    import subprocess
    import sys
    import tempfile
    from pathlib import Path
    shapes, _ = unzip(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    with tempfile.TemporaryDirectory(prefix="ref-init-") as tmp:
        out = os.path.join(tmp, "params.npz")
        subprocess.run(
            [sys.executable, "-c", _REFERENCE_INIT, arch, out], check=True,
            env={**os.environ, "PYTHONHASHSEED": "0", "JAX_PLATFORMS": "cpu",
                 "PYTHONPATH": str(Path(__file__).resolve().parents[1]
                                   / "src")})
        with np.load(out) as got:
            arrays = [got[f"arr_{i}"] for i in range(len(got.files))]
    treedef = jax.tree_util.tree_structure(shapes)
    return jax.tree_util.tree_unflatten(treedef,
                                        [jnp.asarray(a) for a in arrays])


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, its params, port model, the same params) of the
    reduced ``arch`` in f32 compute."""
    jcfg = jconfigs.reduced(arch).replace(compute_dtype="float32")
    cfg = configs.reduced(arch).replace(compute_dtype="float32")
    jm = JModel(jcfg)
    jp = _reference_params(jm, arch)
    return jm, jp, Model(cfg), _port(jp)


@pytest.fixture(scope="module")
def pair():
    return _pair(ARCH)


# the architectures trained here: qwen's cases keep their first ids
MOE_ARCH, SSM_ARCH = "granite-moe-3b-a800m", "mamba2-1.3b"
HYBRID_ARCH = "recurrentgemma-9b"
VLM_ARCH, ENCDEC_ARCH = "paligemma-3b", "seamless-m4t-large-v2"
OTHER_ARCHS = (MOE_ARCH, SSM_ARCH, HYBRID_ARCH, VLM_ARCH, ENCDEC_ARCH)
ARCH_REMAT = [pytest.param(ARCH, r, id=r) for r in ("none", "block")] + [
    pytest.param(a, r, id=f"{a}-{r}") for a in OTHER_ARCHS
    for r in ("none", "block")]
ARCH_WD = [pytest.param(ARCH, wd, id=str(wd)) for wd in (0.1, 0.0)] + [
    pytest.param(a, 0.1, id=f"{a}-0.1") for a in OTHER_ARCHS]
# The reference's kernels path for each model.  mamba2's is its SSD
# oracle (``ref.ssd_ref``, the sequential scan), not the chunked XLA
# form: that one exponentiates differences of f32 cumulative sums and
# takes each exponent's gradient as a row sum less a column sum, so its
# own dt and A gradients lie up to 7e-6 and 1.8e-5 of their largest
# entries from an f64 oracle at reduced mamba2's heads, 8-40x the port's
# plain backward (``tools/cpu_tolerance_scan.py``'s ORACLE lines).
# recurrentgemma's associative scan (``ops._rglru_assoc``) agrees with
# its sequential oracle to 1.4e-6 of each gradient leaf's largest entry.
JIMPL = {ARCH: "xla", MOE_ARCH: "xla", SSM_ARCH: "ref", HYBRID_ARCH: "xla",
         VLM_ARCH: "xla", ENCDEC_ARCH: "xla",
         # tests/test_torch_train_breadth.py's models
         "gemma3-12b": "xla", "deepseek-moe-16b": "xla",
         "command-r-35b": "xla", "nemotron-4-340b": "xla"}
# The trajectories' gradient norm at each step.  AdamW's step is about
# lr whatever the gradient's size, so an element whose gradient lies near
# eps parts by up to lr between the two sides after one step; from then
# on the gradient norms differ by up to 1.8e-5 (mamba2) and 7e-6
# (granite) over 32 weight draws (the reference's init hashes parameter
# paths with Python's ``hash``, so each hash seed draws other weights;
# ``tools/cpu_tolerance_scan.py``; the tests draw under a fixed one,
# ``_reference_params``).  qwen keeps its 1e-5, and so does
# recurrentgemma (7.5e-7 at most over 12 draws); the loss at 1e-4 and
# every parameter leaf within lr / 2 hold for all four.
GRAD_NORM_RTOL = {ARCH: 1e-5, MOE_ARCH: 1e-4, SSM_ARCH: 1e-4,
                  HYBRID_ARCH: 1e-5, VLM_ARCH: 1e-5, ENCDEC_ARCH: 1e-5}


def _zero_grads(grads) -> list:
    """Pop the gradient leaves that are zero in exact arithmetic: the key
    bias of cross attention (no RoPE: q . bk adds the same logit to every
    key of a query, which the softmax cancels), rounding noise on both
    sides."""
    return [layer["cross"].pop("bk") for layer in grads["layers"]
            if "bk" in layer.get("cross", {})]


def _leaf_close(got, want, rel=1e-4):
    zeros = _zero_grads(got) + _zero_grads(want)
    if zeros:
        # noise far below every other leaf's gradient, on both sides
        top = max(float(w.abs().max()) for w in leaves(want))
        assert max(float(z.abs().max()) for z in zeros) <= 1e-6 * top
    for g, w in zip(leaves(got), leaves(want)):
        assert g.shape == w.shape
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= rel * max(scale, 1e-30), (tuple(g.shape), err, scale)


@pytest.mark.parametrize("arch,remat", ARCH_REMAT)
def test_loss_and_gradients_match_reference(arch, remat):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(0, tm.cfg.vocab, cfg=tm.cfg)
    at = _span(tm.cfg)
    batch["targets"][0, at:at + 5] = -1     # ignored positions count too

    def jloss(params):
        return jm.loss_fn(params, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, impl=JIMPL[arch],
                          remat="none")
    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    loss, metrics, grads = loss_and_grads(tm, tp, _tbatch(batch),
                                          remat=remat)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for key in ("ce", "z_loss", "moe_lb", "moe_z"):
        np.testing.assert_allclose(float(metrics[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    if arch == MOE_ARCH:         # granite's layers carry the aux losses
        assert float(metrics["moe_lb"]) > 0 and float(metrics["moe_z"]) > 0
    assert int(metrics["tokens"]) == int(jmet["tokens"]) == B * S - 5
    # the tied embedding takes gradient from the gather and the unembed
    _leaf_close(grads, _port(jg))


def test_moe_layers_drop_over_capacity_in_training():
    """Reduced granite's train-mode layers drop (C = ceil(T k / E 1.25)
    = 40 slots an expert at 4 x 32 tokens, top-2 of 8), where serving's
    would not: the router sees the capacity factor's C."""
    from repro_torch.models import moe as moe_layer
    _, _, tm, tp = _pair(MOE_ARCH)
    seen = []

    def spy(logits, k, **kw):
        r = router(logits, k, **kw)
        seen.append((kw["capacity"], int((r.slot == r.src.numel()).sum())))
        return r
    router = moe_layer.router_dispatch
    moe_layer.router_dispatch = spy
    try:
        loss_and_grads(tm, tp, _tbatch(_batch(0, tm.cfg.vocab)),
                       remat="none")
    finally:
        moe_layer.router_dispatch = router
    assert [c for c, _ in seen] == [40] * tm.cfg.n_layers
    assert sum(d for _, d in seen) > 0


def test_hybrid_gradients_repeat_bitwise():
    """Two runs of reduced recurrentgemma's loss and gradients from the
    same weights and batch (RG-LRU, local attention, GeGLU, the tied
    embedding under the softcap) give equal bits: no sum on the path
    depends on a run's timing."""
    _, _, tm, tp = _pair(HYBRID_ARCH)
    batch = _tbatch(_batch(3, tm.cfg.vocab))
    runs = [loss_and_grads(tm, tp, batch, remat="none") for _ in range(2)]
    (l1, _, g1), (l2, _, g2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g1), leaves(g2)))
    assert any(float(g.abs().max()) > 0 for g in leaves(g1))


# ---------------------------------------------------------------------------
# optim, mirroring tests/test_optim.py
# ---------------------------------------------------------------------------
def _toy(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32),
            "stack": [rng.standard_normal((2, 3)).astype(np.float32)]}


def _jtoy(tree):
    return {"w": jnp.asarray(tree["w"]), "b": jnp.asarray(tree["b"]),
            "stack": (jnp.asarray(tree["stack"][0]),)}


def _ttoy(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jleaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup=10, decay_steps=100, min_lr_frac=0.1)
    jcfg, tcfg = joptim.OptConfig(**cfg), optim.OptConfig(**cfg)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(joptim.schedule(jcfg, jnp.asarray(steps)))
    got = optim.schedule(tcfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0 and abs(got[10] - 1e-3) < 1e-9


@pytest.mark.parametrize("clip", [1.0, 1e-3, 0.0])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_matches_reference(name, clip):
    """Three updates from the same parameters and gradients: weight decay
    on the 2-D leaves only, the clip from the global norm (1e-3 clips,
    0 turns it off), bias correction at the count."""
    kw = dict(name=name, lr=1e-2, warmup=1, decay_steps=10, grad_clip=clip)
    jcfg, tcfg = joptim.OptConfig(**kw), optim.OptConfig(**kw)
    params, jp = _ttoy(_toy(0)), _jtoy(_toy(0))
    if name == "adamw":
        jst = {"m": jax.tree_util.tree_map(jnp.zeros_like, jp),
               "v": jax.tree_util.tree_map(jnp.zeros_like, jp),
               "count": jnp.int32(0)}
        tst = optim.adamw_init(params)
    else:
        jst, _ = unzip(joptim.adafactor_init(
            jax.tree_util.tree_map(lambda a: _P(a), jp)))
        tst = optim.adafactor_init(params)
    for i in range(3):
        g = _toy(10 + i)
        jg, tg = _jtoy(g), _ttoy(g)
        if name == "adamw":
            jp, jm, jv, jc, jstats = joptim.adamw_update(
                jcfg, jp, jg, jst["m"], jst["v"], jst["count"])
            jst = {"m": jm, "v": jv, "count": jc}
            _, _, _, tc, tstats = optim.adamw_update(
                tcfg, params, tg, tst["m"], tst["v"], tst["count"])
        else:
            jp, jf, jc, jstats = joptim.adafactor_update(
                jcfg, jp, jg, jst["f"], jst["count"])
            jst = {"f": jf, "count": jc}
            _, _, tc, tstats = optim.adafactor_update(
                tcfg, params, tg, tst["f"], tst["count"])
        tst["count"] = tc
        assert int(tc) == int(jc) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[key]),
                                       float(jstats[key]), rtol=1e-6)
        for got, want in zip(leaves(params), _jleaves(jp)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-7)
    state = {k: v for k, v in tst.items() if k != "count"}
    jstate = {k: v for k, v in jst.items() if k != "count"}
    for got, want in zip(leaves(state), _jleaves(jstate)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-9)


def _P(a):
    from repro.models.common import P
    return P(a, (None,) * a.ndim)


def test_grad_clip_bounds_the_step():
    cfg = optim.OptConfig(lr=1.0, grad_clip=1e-3, weight_decay=0.0,
                          warmup=0, decay_steps=10)
    params = _ttoy(_toy(0))
    before = params["w"].clone()
    big = tree_map(lambda x: torch.full_like(x, 100.0), params)
    st = optim.adamw_init(params)
    optim.adamw_update(cfg, params, big, st["m"], st["v"], st["count"])
    assert float((params["w"] - before).abs().max()) <= 1.05


def test_state_dtype_policy():
    st = optim.cast_state(optim.adamw_init(_ttoy(_toy(0))), "bfloat16")
    assert st["m"]["w"].dtype == torch.bfloat16
    assert st["v"]["stack"][0].dtype == torch.bfloat16
    assert st["count"].dtype == torch.int32
    model = Model(configs.reduced(ARCH))
    state = init_state(model, optim.OptConfig(state_dtype="bfloat16"), 0,
                       device="cpu")
    assert {x.dtype for x in leaves(state["opt"]["m"])} == {torch.bfloat16}
    assert set(state) == {"params", "opt"}
    assert set(state["opt"]) == {"m", "v", "count"}
    state = init_state(model, optim.OptConfig(name="adafactor"), 0,
                       device="cpu")
    assert set(state["opt"]) == {"f", "count"}


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _run_both(pair, ocfg, steps, microbatches=1, b=B, grads=False):
    """``steps`` steps of the jitted reference step and of the port's
    from the same weights on the same batches.  Yields, after each step,
    (port state, port metrics, reference state as the port's trees,
    reference metrics); with ``grads`` also each side's gradients of the
    step's batch at the weights that side started the step from (the
    port's ``loss_and_grads``, ``jax.grad`` of the reference's
    ``loss_fn``; both as the port's trees)."""
    jm, jp, tm, tp = pair
    par = dict(remat="none", microbatches=microbatches)
    jstep = jax.jit(jmake_train_step(jm, joptim.OptConfig(**ocfg),
                                     JParallelConfig(**par),
                                     impl=JIMPL[tm.cfg.name]))
    jstate, _ = jinit_state(jm, joptim.OptConfig(**ocfg),
                            jax.random.PRNGKey(0))
    jstate = dict(jstate, params=jp)      # the pair's weights
    params = tree_map(torch.clone, tp)
    stacks = stack_groups(tm, params)
    opt = (optim.adafactor_init(params, stacks)
           if ocfg.get("name") == "adafactor" else optim.adamw_init(params))
    state = {"params": params, "opt": opt}
    step = make_train_step(tm, optim.OptConfig(**ocfg),
                           ParallelConfig(**par))
    jgrad = jax.jit(jax.grad(lambda p, bt: jm.loss_fn(
        p, bt, impl=JIMPL[tm.cfg.name], remat="none")[0]))
    for i in range(steps):
        batch = _batch(100 + i, tm.cfg.vocab, b=b, cfg=tm.cfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        seen = ()
        if grads:
            seen = (loss_and_grads(tm, state["params"], _tbatch(batch),
                                   remat="none")[2],
                    _port(jgrad(jstate["params"], jbatch)))
        jstate, jmet = jstep(jstate, jbatch)
        state, met = step(state, _tbatch(batch))
        jport = {"params": _port(jstate["params"])}
        if "m" in jstate["opt"]:
            jport["m"] = _port(jstate["opt"]["m"])
        yield (state, met, jport, jmet) + seen


def _params_close(got, want, lr):
    """Every parameter leaf after AdamW steps at ``lr``: its mean
    |difference| within lr/50 and each element within lr/2.  AdamW moves
    a parameter by about lr a step, in the sign of its gradient's running
    mean, so an element whose gradient is near 0 (summed in another order
    on each side) may part by a fraction of lr (up to 0.1 lr seen); a
    wrong rule moves a whole leaf (the norm scales without their decay:
    0.45 lr over 5 steps).  A leaf whose gradient is zero in exact
    arithmetic (``_zero_grads``) moves by AdamW's reading of rounding
    noise on each side: it is held to the element bound alone."""
    for g, w in zip(_zero_grads(got), _zero_grads(want)):
        assert float((g - w).abs().max()) <= lr / 2
    for g, w in zip(leaves(got), leaves(want)):
        d = (g - w).abs()
        assert float(d.mean()) <= lr / 50 and float(d.max()) <= lr / 2, \
            (tuple(g.shape), float(d.mean()), float(d.max()), lr)


@pytest.mark.parametrize("arch,wd", ARCH_WD)
def test_adamw_trajectory_matches_reference(arch, wd):
    """5 AdamW steps of the jitted reference step and of the port's, from
    the same weights on the same batches: the loss and the gradient norm
    at every step, and every parameter leaf after the last.  With weight
    decay the port decays what the reference decays: its per-layer norm
    scales (and mamba2's A_log, D, dt_bias) are 1-D, the reference's are
    stacked (layers, d) and so take decay (``stack_groups``)."""
    ocfg = dict(lr=3e-3, warmup=2, decay_steps=10, weight_decay=wd)
    for i, (state, met, jstate, jmet) in enumerate(
            _run_both(_pair(arch), ocfg, 5)):
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL[arch],
                                   err_msg=f"step {i}")
    _params_close(state["params"], jstate["params"], ocfg["lr"])


def test_adafactor_trajectory_matches_reference(pair):
    """5 Adafactor steps with weight decay, as the AdamW trajectory: the
    port factors the second moment of the 1-D per-layer leaves over the
    group of layers the reference stacks (a row per layer, a column
    shared), and decays them.  Adafactor's step scales with the gradient,
    so every leaf holds to 1e-4 of its largest entry."""
    ocfg = dict(name="adafactor", lr=3e-3, warmup=2, decay_steps=10,
                weight_decay=0.1)
    for i, (state, met, jstate, jmet) in enumerate(
            _run_both(pair, ocfg, 5)):
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5,
                                   err_msg=f"step {i}")
    _leaf_close(state["params"], jstate["params"])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-moe-16b",
                                  "recurrentgemma-9b", MOE_ARCH, SSM_ARCH,
                                  VLM_ARCH, ENCDEC_ARCH])
def test_stack_groups_are_the_reference_stacks(arch):
    """The leaves that ``stack_groups`` puts together are those that the
    bridge cuts out of one stacked reference tensor: each leaf of the
    reference's scanned periods (and of an encoder-decoder's
    ``encoder.stack``) filled with its own number and every other leaf
    with 0, carried over, groups by number (deepseek's dense layer 0 and
    a partial trailing period stand alone)."""
    jm = JModel(jconfigs.reduced(arch))
    shapes, _ = unzip(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    ids = iter(range(1, 1 << 20))
    labelled = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, np.float32), shapes)
    labelled["periods"] = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, next(ids), np.float32),
        shapes["periods"])
    if "encoder" in shapes:
        labelled["encoder"]["stack"] = jax.tree_util.tree_map(
            lambda x: np.full(x.shape, next(ids), np.float32),
            shapes["encoder"]["stack"])
    tree = params_from_numpy(labelled, device="cpu")
    by_id = {}
    for pos, leaf in enumerate(leaves(tree)):
        by_id.setdefault(int(leaf.flatten()[0]), []).append(pos)
    want = sorted(g for i, g in by_id.items() if i)
    got = sorted(stack_groups(Model(configs.reduced(arch)), tree))
    assert got == want and want


def test_microbatches_equal_one_batch(pair):
    """make_train_step(microbatches=4) == microbatches=1 for the same
    total batch: the loss, the gradient norm, AdamW's m after one step
    ((1 - b1) times the clipped mean gradient, so every microbatch's
    gradient counts) and the updated weights."""
    _, _, tm, tp = pair
    ocfg = optim.OptConfig(lr=1e-3, warmup=0, decay_steps=10)
    batch = _tbatch(_batch(7, tm.cfg.vocab, b=8))
    outs = []
    for n in (1, 4):
        params = tree_map(torch.clone, tp)
        state = {"params": params, "opt": optim.adamw_init(params)}
        step = make_train_step(tm, ocfg, ParallelConfig(microbatches=n,
                                                        remat="none"))
        outs.append(step(state, batch))
    (s1, m1), (s4, m4) = outs
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m4["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    _leaf_close(s4["opt"]["m"], s1["opt"]["m"], rel=1e-5)
    _params_close(s4["params"], s1["params"], ocfg.lr)


def test_microbatches_match_reference(pair):
    """The port's microbatches=4 step against the reference's (its scan
    over microbatches) on one batch of 8: the loss, the gradient norm,
    AdamW's m leaf by leaf and the weights."""
    ocfg = dict(lr=1e-3, warmup=0, decay_steps=10)
    (state, met, jstate, jmet), = _run_both(pair, ocfg, 1, microbatches=4,
                                            b=8)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    _leaf_close(state["opt"]["m"], jstate["m"], rel=1e-5)
    _params_close(state["params"], jstate["params"], ocfg["lr"])


def test_checkpoint_restart_determinism():
    """Train 6 steps straight == train 3, save, restore into a fresh
    state of another seed, train 3 more (the port's CheckpointClient)."""
    cfg = configs.reduced(ARCH).replace(compute_dtype="float32")
    model = Model(cfg)
    ocfg = optim.OptConfig(lr=1e-3, warmup=0, decay_steps=100)
    step = make_train_step(model, ocfg, ParallelConfig(remat="none"))
    batches = [_tbatch(_batch(i, cfg.vocab)) for i in range(6)]

    state = init_state(model, ocfg, 0, device="cpu")
    for i in range(6):
        state, _ = step(state, batches[i])
    direct = state

    with Engine(None) as e:
        CheckpointServer(e, device="cpu")
        cli = CheckpointClient(e, e.uri)
        state = init_state(model, ocfg, 0, device="cpu")
        for i in range(3):
            state, _ = step(state, batches[i])
        cli.save("t", 3, state)
        fresh = init_state(model, ocfg, 42, device="cpu")   # wrong init
        restored, at = cli.restore("t", fresh, device="cpu")
        assert at == 3 and int(restored["opt"]["count"]) == 3
        for i in range(3, 6):
            restored, _ = step(restored, batches[i])

    for a, b in zip(leaves(direct["params"]), leaves(restored["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_launcher_trains_on_the_cpu(capsys):
    out = train_launcher.main(["--reduced", "--steps", "4", "--device",
                               "cpu", "--ckpt-every", "2"])
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert [c["step"] for c in out["checkpoints"]] == [2, 4]
    assert "tok/s" in capsys.readouterr().out


def test_launcher_trains_mamba2_on_the_cpu(capsys):
    """--arch mamba2-1.3b: the SSD layers train through SSDFunction (its
    plain backward here); the loss falls and the end's save lands."""
    out = train_launcher.main(["--arch", SSM_ARCH, "--reduced", "--steps",
                               "4", "--device", "cpu", "--ckpt-every", "4"])
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert [c["step"] for c in out["checkpoints"]] == [4]
    assert "tok/s" in capsys.readouterr().out


def test_launcher_trains_recurrentgemma_on_the_cpu(capsys):
    """--arch recurrentgemma-9b: the RG-LRU layers train through
    RGLRUFunction (its plain backward here), the local attention layers
    through AttentionFunction; 2 steps, finite losses, the end's save."""
    out = train_launcher.main(["--arch", HYBRID_ARCH, "--reduced", "--steps",
                               "2", "--device", "cpu", "--ckpt-every", "2"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert [c["step"] for c in out["checkpoints"]] == [2]
    assert "tok/s" in capsys.readouterr().out


@pytest.mark.parametrize("arch", [VLM_ARCH, ENCDEC_ARCH])
def test_launcher_trains_frontend_models_on_the_cpu(arch, capsys):
    """--arch paligemma-3b / seamless-m4t-large-v2: seeded frontend
    batches over RPC beside the tokens (paligemma's targets padded over
    its patches); the loss falls over 4 steps and the end's save lands."""
    out = train_launcher.main(["--arch", arch, "--reduced", "--steps", "4",
                               "--device", "cpu", "--ckpt-every", "4"])
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert [c["step"] for c in out["checkpoints"]] == [4]
    assert "tok/s" in capsys.readouterr().out


def test_launcher_pads_vlm_targets_over_the_patches():
    """A VLM's targets (B,S) gain F leading -1 (no target) positions."""
    got = train_launcher.vlm_targets(torch.tensor([[3, 4], [5, 6]]), 3)
    assert got.tolist() == [[-1, -1, -1, 3, 4], [-1, -1, -1, 5, 6]]


def test_launcher_resumes_from_an_external_server():
    """--resume --ckpt-uri: a second run restores the first run's last
    checkpoint from a server on its own engine over tcp."""
    with Engine("tcp://127.0.0.1:0") as e:
        CheckpointServer(e, device="cpu")
        args = ["--reduced", "--steps", "2", "--device", "cpu",
                "--ckpt-uri", e.uri, "--resume"]
        first = train_launcher.main(args)
        second = train_launcher.main(args)
    assert [c["step"] for c in first["checkpoints"]] == [2]
    assert [c["step"] for c in second["checkpoints"]] == [2, 4]


def test_launcher_does_not_fall_back_to_the_cpu():
    """The trainer runs on the card unless --device cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = Model(configs.reduced(ARCH))
    for call in (lambda: train_launcher.main(["--reduced", "--steps", "1"]),
                 lambda: init_state(model, optim.OptConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
