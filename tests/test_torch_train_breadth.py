"""The port's training plane on four more configurations, against the JAX
reference on the CPU, with ``tests/test_torch_train.py``'s helpers.

Reduced gemma3-12b (five local layers and a global one, qk-norm, GeGLU,
the scaled tied embedding, two RoPE bases), deepseek-moe-16b (a dense
layer 0, routed and shared experts, the aux losses), command-r-35b (the
parallel attention/MLP block, the tied embedding) and nemotron-4-340b
(squared-ReLU MLP, GQA, untied tables) in f32 compute, the reference's
weights drawn under a fixed hash seed (``_reference_params``):

- ``Model.loss_fn``'s loss, metrics and every gradient leaf against
  ``jax.value_and_grad`` of the reference's, remat "none" and "block";
  gemma3 also at 2 x 96 tokens, where its 32-token window binds;
- 5-step AdamW trajectories (the loss and gradient norm at every step,
  every parameter leaf after the last) and command-r's 5-step Adafactor
  one (the optimizer ``chip_smoke.py`` phase 3u trains it with);
- the launcher at reduced size on the CPU;
- ``chip_smoke.TRAIN_BREADTH``'s cuts: each holds every layer kind of
  its config, and each row's parameters, gradients and optimizer state
  are reckoned under one 80 GB card.

nemotron's AdamW trajectory holds one element that the other three do
not: ``embed/embedding[246, 9]``, whose token occurs once in the five
batches (step 3).  Its gradient there is 1.2e-6 of its row's largest
entry; each side computes it right for its own weights (the port's f32
+1.95e-8 beside f64's +1.72e-8, the reference's -2.47e-8 beside f64's
-2.53e-8), but the two sides' weights have drifted apart by their
earlier rounding, and in that row their gradients part by up to
6.89e-8: the element's sign is rounding's.  AdamW's first step on a
fresh row moves each element by about lr in its gradient's sign whatever
its size, so the two sides move it apart by ~lr.  ``_params_close_noisy``
holds such elements (the two sides' gradients of opposite signs at a
step) to 2 lr for each such step, at most one in 10^4 elements of a
leaf, and every other element to ``_params_close``'s bounds.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from test_torch_train import (JIMPL, _batch, _leaf_close,  # noqa: E402
                              _pair, _params_close, _port, _run_both,
                              _tbatch)

ROOT = Path(__file__).resolve().parents[1]
GEMMA, DEEPSEEK, COMMAND_R, NEMOTRON = ("gemma3-12b", "deepseek-moe-16b",
                                        "command-r-35b", "nemotron-4-340b")
ARCHS = (GEMMA, DEEPSEEK, COMMAND_R, NEMOTRON)
B, S = 4, 32
# the trajectories' gradient norm at every step: nemotron's parts by 7e-7
# relative at most, the others' by less
GRAD_NORM_RTOL = 1e-5
# an element within the rounding noise of its row at a step is held to
# NOISY_BOUND lr for each such step; at most one in NOISY_SHARE of a leaf
NOISY_BOUND, NOISY_SHARE = 2.0, 10 ** 4


def _check_loss_and_grads(arch, remat, b=B, s=S):
    """The loss, metrics and every gradient leaf of one seeded batch
    (its first 5 targets of row 0 ignored) against the reference's;
    returns the port's loss."""
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(0, tm.cfg.vocab, b=b, s=s)
    batch["targets"][0, :5] = -1

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
    if tm.cfg.moe.num_experts:
        assert float(metrics["moe_lb"]) > 0 and float(metrics["moe_z"]) > 0
    assert int(metrics["tokens"]) == int(jmet["tokens"]) == b * s - 5
    _leaf_close(grads, _port(jg))
    return float(loss)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "block"])
def test_loss_and_gradients_match_reference(arch, remat):
    _check_loss_and_grads(arch, remat)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_gemma3_window_binds_in_training(remat):
    """2 x 96 tokens against the reduced window of 32: the local layers'
    forward and backward drop the keys that fall out of the window (the
    loss differs from the same weights' loss with the window widened to
    the sequence), and the loss and every gradient leaf still agree."""
    _, _, tm, tp = _pair(GEMMA)
    assert tm.cfg.window == 32 and "global" in tm.kinds
    loss = _check_loss_and_grads(GEMMA, remat, b=2, s=96)
    wide = Model(tm.cfg.replace(window=96))
    batch = _batch(0, tm.cfg.vocab, b=2, s=96)
    batch["targets"][0, :5] = -1
    with torch.no_grad():
        whole, _ = wide.loss_fn(tp, _tbatch(batch), remat="none")
    assert abs(float(whole) - loss) > 1e-4 * abs(loss)


def _params_close_noisy(got, want, lr, seen):
    """``_params_close``'s bounds after AdamW steps at ``lr``, but for the
    elements AdamW moved on rounding noise.  ``seen`` holds, for each
    step, (the port's gradients, the reference's) at the weights each
    side started that step from.  At a step where the two sides'
    gradients of an element have opposite signs, each lies within the gap
    between them, within its row's noise: its sign is rounding's, and
    AdamW's step, about lr whatever |g|, goes one way on one side and the
    other on the other.  Such an element is held to NOISY_BOUND lr for
    each such step, and at most one in NOISY_SHARE elements of a leaf may
    be one; every other element to lr / 2, every leaf's mean to lr / 50.
    Returns the noisy elements' count by leaf."""
    noisy = [torch.zeros(g.shape, dtype=torch.int64) for g in leaves(got)]
    for port, ref in seen:
        for n, g, r in zip(noisy, leaves(port), leaves(ref)):
            n += (g * r < 0).long()
    counts = {}
    for i, (n, g, w) in enumerate(zip(noisy, leaves(got), leaves(want))):
        d = (g - w).abs()
        flagged = int((n > 0).sum())
        if flagged:
            counts[f"{i} {tuple(g.shape)}"] = flagged
        bound = torch.where(n > 0, NOISY_BOUND * lr * n, lr / 2)
        assert flagged * NOISY_SHARE <= g.numel(), (tuple(g.shape), flagged)
        assert float(d.mean()) <= lr / 50 and bool((d <= bound).all()), \
            (tuple(g.shape), float(d.mean()), float(d.max()), lr)
    return counts


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_trajectory_matches_reference(arch):
    """5 AdamW steps (weight decay 0.1) of the jitted reference step and
    of the port's from the same weights on the same batches: the loss and
    gradient norm at every step, every parameter leaf after the last
    (nemotron's under ``_params_close_noisy``)."""
    ocfg = dict(lr=3e-3, warmup=2, decay_steps=10, weight_decay=0.1)
    noisy = arch == NEMOTRON
    seen = []
    for i, out in enumerate(_run_both(_pair(arch), ocfg, 5, grads=noisy)):
        state, met, jstate, jmet = out[:4]
        seen.append(out[4:])
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL, err_msg=f"step {i}")
    if noisy:
        counts = _params_close_noisy(state["params"], jstate["params"],
                                     ocfg["lr"], seen)
        print(f"{arch}: elements within their row's noise, by leaf "
              f"{counts}")
    else:
        _params_close(state["params"], jstate["params"], ocfg["lr"])


def test_command_r_adafactor_trajectory_matches_reference():
    """5 Adafactor steps with weight decay, as test_torch_train.py's for
    qwen: the loss and gradient norm at every step, every leaf within
    1e-4 of its largest entry (Adafactor's step scales with the
    gradient)."""
    ocfg = dict(name="adafactor", lr=3e-3, warmup=2, decay_steps=10,
                weight_decay=0.1)
    for i, (state, met, jstate, jmet) in enumerate(
            _run_both(_pair(COMMAND_R), ocfg, 5)):
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL, err_msg=f"step {i}")
    _leaf_close(state["params"], jstate["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_the_cpu(arch, capsys):
    """--arch A --reduced --device cpu --steps 2: batches over RPC, two
    finite losses and the end's save."""
    out = train_launcher.main(["--arch", arch, "--reduced", "--steps", "2",
                               "--device", "cpu", "--ckpt-every", "2"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert [c["step"] for c in out["checkpoints"]] == [2]
    assert "tok/s" in capsys.readouterr().out


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _layer_types(model):
    """Each layer's (kind, feed-forward): dense before a MoE config's
    first routed layer, else "moe" or "mlp"."""
    moe = model.cfg.moe.num_experts and model.cfg.d_ff > 0
    return {(kind, "dense" if i < model.prefix_count
             else "moe" if moe else "mlp")
            for i, kind in enumerate(model.kinds)}


@pytest.mark.parametrize("row", range(3))
def test_train_breadth_cuts_hold_every_layer_kind(row):
    """A row of ``chip_smoke.TRAIN_BREADTH`` trains every layer kind its
    config has (gemma3's local and global layers; deepseek's dense layer
    0 and its MoE layers; command-r's parallel block), and its
    parameters, gradients and optimizer state are reckoned under one
    80 GB card."""
    c = _chip_smoke()
    phase, arch, layers, opt, lr, batch, seq, steps = c.TRAIN_BREADTH[row]
    full = Model(configs.get(arch))
    cut = Model(configs.get(arch).replace(n_layers=layers))
    assert _layer_types(cut) == _layer_types(full)
    assert cut.cfg.n_layers < full.cfg.n_layers and steps >= 3 and lr > 0
    reckoned = c.train_state_bytes(arch, layers, opt)
    assert reckoned["total"] < 80e9, (phase, reckoned)
    if arch == GEMMA:
        assert seq > full.cfg.window and {"local", "global"} <= set(cut.kinds)
    if arch == DEEPSEEK:
        assert cut.prefix_count == 1 and cut.cfg.moe.top_k == 6
