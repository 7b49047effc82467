"""The plain reference against the port's CPU path at reduced width, in
f32: the training loss, every gradient leaf, three AdamW steps' change,
and the update itself."""
import copy

import pytest
import torch

import benchtiny
from benchlib import check, portcfg, spec, traffic, train, weights
from reference import common


def f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["port"].update(param_dtype="float32", compute_dtype="float32")
    return cfg


CELLS = [(w["config"], w["traffic"]) for w in spec.load_spec()["workloads"]]
# the tests' own DeepSeekMoE file (``bench/tests/fixtures``), of the
# family ``moe_decoder``
FIXTURES = [("moe-port-rules", "pretrain_4k")]


@pytest.mark.parametrize("config,mix_name", CELLS + FIXTURES)
def test_reference_training_matches_the_port(config, mix_name):
    """Three steps' losses, every leaf of the first gradient and every
    leaf's change, the reduced model in f32 on both sides."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import Model
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    cfg = f32(benchtiny.tiny_config(config))
    mix = benchtiny.tiny_mix(mix_name)
    model = Model(portcfg.port_config(cfg))
    w = weights.stacked(cfg, 5, "cpu", torch.float32)
    params = weights.port_tree(cfg, w)
    state = {"params": params, "opt": optim.adamw_init(params)}
    step = make_train_step(model, train.opt_config(mix),
                           ParallelConfig(remat="none"))
    ocfg = train.opt_config(mix)
    losses = []
    for s in range(3):
        b = traffic.train_batch(mix, cfg["vocab_size"], 5, s)
        _, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(met["loss"]))
        if s == 0:
            got_grad = {k: v / (1 - ocfg.b1)
                        for k, v in train.norms(state["opt"]["m"]).items()}
    w0 = weights.port_tree(cfg, weights.stacked(cfg, 5, "cpu",
                                                torch.float32))
    w0 = train.paths(w0)
    got_change = {k: float(torch.linalg.vector_norm(v - w0[k]))
                  for k, v in train.paths(state["params"]).items()}

    ref = train.reference_steps(cfg, mix, 5, "cpu")
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) < 1e-5 * b
    assert set(got_grad) == set(ref["grad"]) == set(ref["change"])
    for k, v in ref["grad"].items():
        assert abs(got_grad[k] - v) <= 1e-4 * max(v, 1e-6), k
    # each leaf's change against the larger of its own and the median
    # leaf's, as the harness compares it: a key bias barely moves
    assert check.leaf_gap(got_change, ref["change"]) <= 1e-4


def test_adamw_matches_the_port():
    from repro_torch.train import optim
    ocfg = optim.OptConfig(lr=1e-2, warmup=1)
    g = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(4, 3, generator=g), "n": torch.ones(3)}
    grads = {"a": torch.randn(4, 3, generator=g),
             "n": torch.randn(3, generator=g)}
    port = {k: v.clone() for k, v in p.items()}
    optim.adamw_update(ocfg, port, grads, optim.adamw_init(port)["m"],
                       optim.adamw_init(port)["v"],
                       torch.zeros((), dtype=torch.int32))
    ref = {k: v.clone() for k, v in p.items()}
    opt = {k: getattr(ocfg, k) for k in ("lr", "b1", "b2", "eps",
                                         "weight_decay", "grad_clip",
                                         "warmup", "decay_steps",
                                         "min_lr_frac")}
    common.AdamW(opt, ref, lambda n: 1.0 if ref[n].ndim > 1 else 0.0
                  ).step(grads)
    for k in p:
        assert torch.allclose(port[k], ref[k], atol=1e-6), k
