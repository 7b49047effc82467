"""The families (``bench/families``, ``bench/reference``): a family is
found by the configuration file's ``reference`` key alone; the dense one
draws the weights it drew before it moved there; the DeepSeekMoE
reference against a loop over the tokens; its count by hand; its port
check refuses each rule the port does not run; and the common harness
names no family, no key of one and no leaf."""
import ast
import hashlib
import json
import math
import os
import re
import sys

import pytest
import torch

import benchtiny
import families
import reference
from benchlib import portcfg, train, weights
from counts import model as cm
from families import decoder, moe_decoder as moe_family
from reference import moe_decoder

BENCH = benchtiny.BENCH
MOE = "moe-port-rules"


def digest(w):
    h = hashlib.sha256()
    for name, t in w.items():
        h.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_the_dense_family_draws_the_weights_it_drew_before():
    """``stacked`` at the reduced qwen file, against digests recorded
    from the harness before the family held the draw."""
    cfg = benchtiny.tiny_config("qwen1.5-0.5b")
    got = {seed: digest(weights.stacked(cfg, seed, "cpu", torch.float32))
           for seed in (5, 3141592653)}
    assert got == {
        5: "fcdbccc380061816e4ce7a5ab2b56328da287f36b0dac9a8d7a0fa80e1ccbfac",
        3141592653:
            "7ec1fa45efaeca457d227fa7180120a1a574cb1ada514cf0e80e321f1686a15d"}


NEW_FAMILY = '''
"""A test's family: the dense family's parts, each call recorded, its
CPU-size limits its own."""
from families import decoder

CALLS = []
TINY_LIMITS = {k: 1.5 * v for k, v in decoder.TINY_LIMITS.items()}


def _recorded(name):
    def part(*args):
        CALLS.append(name)
        return getattr(decoder, name)(*args)
    return part


for _name in ("shapes", "port_tree", "port_checks", "multiplied_params",
              "attn_pair_flops", "decays", "tiny"):
    globals()[_name] = _recorded(_name)
'''

NEW_REFERENCE = '''
"""A test's reference: the dense one, each model recorded."""
from . import decoder

MODELS = []


class Model(decoder.Model):
    def __init__(self, *args):
        super().__init__(*args)
        MODELS.append(self)
'''


def test_a_family_in_another_directory_is_found_by_name(tmp_path,
                                                        monkeypatch):
    """A family's two files in a directory of their own, on the packages'
    path, and a configuration file naming it under ``reference``: a cell
    of that file added to a copy of ``BENCHMARK.json`` runs through it,
    every part and its CPU-size limits found by that name, with no file
    of the harness or of its tests edited."""
    for pkg, text in ((families, NEW_FAMILY), (reference, NEW_REFERENCE)):
        d = tmp_path / pkg.__name__
        d.mkdir()
        (d / "tiny_family.py").write_text(text)
        monkeypatch.setattr(pkg, "__path__", [str(d)] + list(pkg.__path__))
    for name in ("families.tiny_family", "reference.tiny_family"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    c = dict(benchtiny.config_file("qwen1.5-0.5b"), reference="tiny_family",
             name="tiny-family")
    (tmp_path / "tiny-family.json").write_text(json.dumps(c))
    monkeypatch.setattr(benchtiny, "FIXTURES", str(tmp_path))
    bench = benchtiny.with_fixture_cells()
    bench["workloads"].append({"name": "tiny-family.pretrain_4k",
                               "config": "tiny-family",
                               "traffic": "pretrain_4k", "chips": 1,
                               "why": "a test"})
    cell = benchtiny.tiny_cell("tiny-family.pretrain_4k", bench)
    fam = sys.modules["families.tiny_family"]
    assert cell.entry["limits"] == fam.TINY_LIMITS != decoder.TINY_LIMITS
    run = benchtiny.run_tiny(cell, seconds=1.0)
    assert set(fam.CALLS) == {"shapes", "port_tree", "port_checks",
                              "multiplied_params", "attn_pair_flops",
                              "decays", "tiny"}
    assert sys.modules["reference.tiny_family"].MODELS
    assert run.correct, run.checks


def test_a_cells_own_tiny_limits_go_before_its_familys(tmp_path,
                                                      monkeypatch):
    """A cell whose CPU-size readings its family's limits do not hold
    brings ``bench/tests/tiny_limits/<cell>.json``, a new file."""
    cell = benchtiny.FIXTURE_CELLS[0]["name"]
    cfg = benchtiny.tiny_config(MOE)
    assert benchtiny.tiny_limits(cell, cfg) == moe_family.TINY_LIMITS
    own = {"grad_gap": 3e-2, "change_gap": 6e-2}
    (tmp_path / f"{cell}.json").write_text(json.dumps(own))
    monkeypatch.setattr(benchtiny, "TINY_LIMITS_DIR", str(tmp_path))
    assert benchtiny.tiny_cell(
        cell, benchtiny.with_fixture_cells()).entry["limits"] == own


# ---------------------------------------------------------------------------
# the DeepSeekMoE reference's layer against a loop over the tokens
# ---------------------------------------------------------------------------
SMALL = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 2,
         "num_hidden_layers": 2, "intermediate_size": 12, "vocab_size": 32,
         "moe_intermediate_size": 4, "n_routed_experts": 6,
         "num_experts_per_tok": 2, "n_shared_experts": 1,
         "first_k_dense_replace": 1, "scoring_func": "softmax",
         "aux_loss_alpha": 0.01, "router_z_loss_coef": 1e-3}


def loop_moe(x, w, lay, B):
    """Token by token in f64: each token's softmax, its k largest, their
    weights (renormalised where the file says), each expert keeping its
    first C assignments in (token, choice) order; the balance loss from
    counts over the batch or each sequence."""
    x = x.double()
    T, d = x.shape
    E, k = lay.E, lay.k
    cap = None if lay.cf is None else math.ceil(T * k / E * lay.cf)

    def ffn(v, g, u, o):
        return (torch.nn.functional.silu(v @ g.double())
                * (v @ u.double())) @ o.double()

    used, y, probs, picks, dropped = [0] * E, [], [], [], 0
    for t in range(T):
        logit = x[t] @ w["router"][0].double()
        s = torch.exp(logit - logit.max())
        s = s / s.sum()
        order = sorted(range(E), key=lambda e: (-float(s[e]), e))[:k]
        gate = [s[e] for e in order]
        if lay.norm_topk:
            gate = [g / sum(gate) for g in gate]
        out = ffn(x[t], w["shared_wi_gate"][0], w["shared_wi_up"][0],
                  w["shared_wo"][0])
        for g, e in zip(gate, order):
            if cap is None or used[e] < cap:
                out = out + g * ffn(x[t], w["expert_wi_gate"][0, e],
                                    w["expert_wi_up"][0, e],
                                    w["expert_wo"][0, e])
            else:
                dropped += 1
            used[e] += 1
        y.append(out)
        probs.append(s)
        picks.append(order)
    groups = B if lay.seq_aux else 1
    n = T // groups
    bal = 0.0
    for g in range(groups):
        rows = range(g * n, (g + 1) * n)
        for i in range(E):
            f = E / (k * n) * sum(picks[t].count(i) for t in rows)
            P = sum(float(probs[t][i]) for t in rows) / n
            bal += f * P / groups
    logits = x @ w["router"][0].double()
    z = float(torch.logsumexp(logits, -1).square().mean())
    aux = lay.alpha * bal + lay.z * z
    return torch.stack(y), aux, dropped


@pytest.mark.parametrize("cf", [0.5, None])
@pytest.mark.parametrize("seq_aux", [False, True])
@pytest.mark.parametrize("norm_topk", [True, False])
def test_the_moe_layer_against_a_loop_over_the_tokens(norm_topk, seq_aux,
                                                      cf):
    cfg = dict(SMALL, norm_topk_prob=norm_topk, seq_aux=seq_aux,
               capacity_factor=cf)
    lay = moe_decoder.Layout(cfg)
    gen = torch.Generator().manual_seed(11)
    shapes = {n: s for n, s, _ in families.of(
        dict(cfg, reference="moe_decoder")).shapes(cfg)}
    w = {n: torch.randn(shapes[n], generator=gen)
         for n in ("router", "expert_wi_gate", "expert_wi_up", "expert_wo",
                   "shared_wi_gate", "shared_wi_up", "shared_wo")}
    B, S = 2, 10
    x = torch.randn(B * S, 8, generator=gen)
    y, aux = moe_decoder.moe(x, w, 0, lay, B, None)
    want, want_aux, dropped = loop_moe(x, w, lay, B)
    assert (dropped > 0) == (cf is not None)
    assert torch.allclose(y.double(), want, rtol=1e-5, atol=1e-5)
    assert math.isclose(float(aux), want_aux, rel_tol=1e-5)


def test_the_moe_reference_takes_only_softmax_scoring():
    with pytest.raises(ValueError):
        moe_decoder.Layout(dict(SMALL, scoring_func="sigmoid",
                                norm_topk_prob=True, seq_aux=False,
                                capacity_factor=None))


# ---------------------------------------------------------------------------
# the port check and the count
# ---------------------------------------------------------------------------
def test_the_port_check_takes_the_ports_rules():
    cfg = benchtiny.config_file(MOE)
    pc = portcfg.port_config(cfg)
    assert pc.moe.num_experts == 64 and pc.n_layers == 5
    assert portcfg.port_config(benchtiny.tiny_config(MOE)).moe.top_k == 2


def _flipped(key):
    """The file with ``key`` set otherwise than the port runs it."""
    cfg = benchtiny.config_file(MOE)
    tried = cfg.get("rules_tried", {})
    if key in tried:
        return dict(cfg, **{key: next(v for v in tried[key]
                                      if v != cfg[key])})
    return dict(cfg, **{
        "capacity_factor_other": {"capacity_factor": 1.0},
        "n_routed_experts": {"n_routed_experts":
                             cfg["n_routed_experts"] // 2},
        "first_k_dense_replace": {"first_k_dense_replace":
                                  1 - cfg["first_k_dense_replace"]},
        "intermediate_size": {"intermediate_size":
                              cfg["moe_intermediate_size"]}}[key])


@pytest.mark.parametrize("key", [
    "norm_topk_prob", "capacity_factor", "capacity_factor_other",
    "seq_aux", "aux_loss_alpha", "router_z_loss_coef", "n_routed_experts",
    "first_k_dense_replace", "intermediate_size"])
def test_the_port_check_refuses_a_rule_or_size_the_port_does_not_run(key):
    """Each rule flipped from the one the port runs (capacity: to the
    other tried value, and to 1.0), and each size changed."""
    with pytest.raises(ValueError, match="differ"):
        portcfg.port_config(_flipped(key))


def test_the_port_check_takes_one_combination_of_the_tried_rules():
    """Of the fixture's tried rules (the port's when it was written, and
    the source's: ``norm_topk_prob`` false, dropless, 0.001 per sequence,
    no z-loss), the check takes the one combination the port runs and
    refuses the 31 others, the published rules among them unless the
    port runs them."""
    path = os.path.join(benchtiny.FIXTURES, f"{MOE}.json")
    with open(path) as f:
        cfg = json.load(f)
    taken = benchtiny.port_rules(cfg)
    assert len(taken) == 1, taken
    assert math.prod(len(v) for v in cfg["rules_tried"].values()) == 32
    assert all(benchtiny.config_file(MOE)[k] == v
               for k, v in taken[0].items())


def test_the_moe_operations_by_hand():
    """deepseek-moe-16b at 5 layers, B 2 x S 4096: 4 x 2048^2 attention a
    layer, layer 0's SwiGLU of 10944, four MoE layers of a 2048 x 64
    router and 6 routed + 2 shared experts of 3 x 2048 x 1408, the
    untied 102400 x 2048 head."""
    cfg = benchtiny.config_file(MOE)
    fam = families.of(cfg)
    per_layer = (5 * 4 * 2048 ** 2 + 3 * 2048 * 10944
                 + 4 * (2048 * 64 + 8 * 3 * 2048 * 1408))
    assert fam.multiplied_params(cfg) == per_layer + 102400 * 2048
    assert fam.multiplied_params(cfg) == 638_189_568
    flops = cm.train_flops(cfg, 2, 4096)
    assert math.isclose(flops, 6 * 8192 * 638_189_568
                        + 3 * 4 * 16 * 128 * 5 * 2 * 4096 * 4097 // 2)
    # all 64 experts are stored, 6 + 2 multiplied
    stored = sum(math.prod(s) for n, s, _ in fam.shapes(cfg)
                 if n.startswith(("expert_", "shared_")))
    assert stored == 4 * (64 + 2) * 3 * 2048 * 1408


# ---------------------------------------------------------------------------
# the common harness names no family
# ---------------------------------------------------------------------------
def _code_words(path):
    """The identifiers and the words of the string literals of a module,
    its docstrings left out."""
    tree = ast.parse(open(path).read())
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            docs.add(id(node.body[0].value))
    words = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            words.add(node.id)
        elif isinstance(node, ast.Attribute):
            words.add(node.attr)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            words.add(node.name)
        elif isinstance(node, ast.arg):
            words.add(node.arg)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            words.update(re.findall(r"[A-Za-z_0-9]+", node.value))
    return words


# keys every language model's file has, which the harness may read
COMMON_KEYS = {"name", "source", "reference", "port", "notes",
               "vocab_size", "num_hidden_layers"}


def test_the_common_harness_names_no_family_key_or_leaf():
    names = {f[:-3] for f in os.listdir(os.path.join(BENCH, "families"))
             if f.endswith(".py") and f != "__init__.py"}
    assert {"decoder", "moe_decoder"} <= names
    keys, leaves = set(), set()
    for cfg in (benchtiny.config_file("qwen1.5-0.5b"),
                benchtiny.config_file(MOE)):
        keys |= set(cfg) - COMMON_KEYS
        tiny = benchtiny.tiny_config(cfg["name"])
        fam = families.of(tiny)
        w = weights.stacked(tiny, 0, "cpu", torch.float32)
        leaves |= set(w)
        for path in train.paths(fam.port_tree(tiny, w)):
            leaves |= {p for p in path.split(".") if not p.isdigit()}
    files = [os.path.join(BENCH, "run.py")] + [
        os.path.join(BENCH, d, f) for d in ("benchlib", "counts")
        for f in os.listdir(os.path.join(BENCH, d)) if f.endswith(".py")]
    for path in files:
        found = _code_words(path) & (names | keys | leaves)
        assert not found, (os.path.relpath(path, BENCH), sorted(found))

