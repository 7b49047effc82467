"""The DeepSeekMoE decoder family (``reference: moe_decoder``): the dense
family's attention blocks, the first ``first_k_dense_replace`` layers
with a SwiGLU MLP and the others with a mixture of experts, as
``reference/moe_decoder.py`` models them.

Each kind of leaf is one tensor stacked over the layers that have it:
the dense MLP over the leading dense layers, the router, the experts
(over the MoE layers, then the experts) and the shared experts over the
MoE layers; a projection at 1/sqrt(fan-in), the router's too.

The port states some of the file's rules in no field of its
``ModelConfig`` (whether the top-k weights are renormalised, dropless
training, a balance loss per sequence), so the check holds them by what
the port does: the port's training loss at a probe's size against the
reference's under the file's rules.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from reference.moe_decoder import Layout

from . import decoder
from .decoder import attn_pair_flops  # noqa: F401  (the dense attention)

# the probe: two MoE layers after the file's dense ones, every rule and
# the experts' count and top-k as the file states them, at small widths
PROBE_SIZES = dict(hidden_size=32, num_attention_heads=2,
                   num_key_value_heads=2, moe_intermediate_size=16,
                   intermediate_size=32, vocab_size=64)
PROBE_ROWS, PROBE_SEQ = 4, 16
# the port's f32 loss on the CPU against the reference's: 0 to 1.1e-7
# apart where the rules agree; any one rule flipped moves it by 1.6e-3
# or more (``bench/tests/test_bench_families.py``)
PROBE_TOL = 2e-6
# the limits of a cell of this family cut to CPU size (``benchtiny``):
# bf16 router logits send some of the reduced file's 96 tokens to other
# experts than the f32 reference does.  On the tests' seed, the port
# renormalising its top-k, at capacity 1.25 and a balance loss of 0.01
# over the batch, its sound run reads grad 1.12e-2, change 1.76e-2; the float8 control grad 9.29e-2, a token altered 3.93e-2, a
# reference renormalising otherwise 0.502, half the batch 0.218 / 0.241,
# a state left unchanged 1
TINY_LIMITS = {"grad_gap": 2.5e-2, "change_gap": 5e-2}


def shapes(cfg: dict) -> List[tuple]:
    """(name, shape, scale) of each stacked tensor, in draw order; a
    scale of 0 marks a norm's scale (ones)."""
    lay = Layout(cfg)
    d, L = lay.d, lay.L
    K, M, E, f, I = lay.dense, lay.moe_layers, lay.E, lay.f, lay.F
    out = decoder.attn_shapes(lay)
    if K:
        out += [("dense_wi_gate", (K, d, I), d ** -0.5),
                ("dense_wi_up", (K, d, I), d ** -0.5),
                ("dense_wo", (K, I, d), I ** -0.5)]
    out += [("router", (M, d, E), d ** -0.5),
            ("expert_wi_gate", (M, E, d, f), d ** -0.5),
            ("expert_wi_up", (M, E, d, f), d ** -0.5),
            ("expert_wo", (M, E, f, d), f ** -0.5)]
    if lay.shared:
        g = lay.shared * f
        out += [("shared_wi_gate", (M, d, g), d ** -0.5),
                ("shared_wi_up", (M, d, g), d ** -0.5),
                ("shared_wo", (M, g, d), g ** -0.5)]
    out += [("norm1", (L, d), 0), ("norm2", (L, d), 0),
            ("final_norm", (d,), 0)]
    return out


def _ffn(n, i):
    return {"wi_gate": n("wi_gate", i), "wi_up": n("wi_up", i),
            "wo": n("wo", i)}


def port_tree(cfg: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree (``repro_torch.models.transformer``'s
    layout: ``mlp`` in a dense layer, ``moe`` in the others), each leaf a
    view of ``w``."""
    lay = Layout(cfg)
    layers = []
    for i in range(lay.L):
        p = {"norm1": w["norm1"][i], "norm2": w["norm2"][i],
             "attn": decoder.attn_tree(lay, w, i)}
        if i < lay.dense:
            p["mlp"] = _ffn(lambda n, j: w[f"dense_{n}"][j], i)
        else:
            j = i - lay.dense
            p["moe"] = dict(_ffn(lambda n, m: w[f"expert_{n}"][m], j),
                            router=w["router"][j])
            if lay.shared:
                p["moe"]["shared"] = _ffn(lambda n, m: w[f"shared_{n}"][m],
                                          j)
        layers.append(p)
    return {"embed": decoder.embed_tree(lay, w), "layers": layers,
            "final_norm": w["final_norm"]}


def port_checks(cfg: dict, pc) -> list:
    """(key, file's value, port's value) for every size the file states,
    that the port's model is one the reference models, and that the port
    trains by the file's routing and loss rules (``probe_gap``)."""
    lay = Layout(cfg)
    m = pc.moe
    out = decoder.attn_checks(cfg, pc) + [
        ("moe_intermediate_size", lay.f, pc.d_ff),
        ("n_routed_experts", lay.E, m.num_experts),
        ("num_experts_per_tok", lay.k, m.top_k),
        ("n_shared_experts", lay.shared, m.num_shared_experts),
        ("first_k_dense_replace", lay.dense, int(m.first_layer_dense)),
        ("pre-norm attention blocks with a mixture of experts",
         (pc.family, pc.period, pc.parallel_block, pc.qk_norm,
          pc.attn_softcap, pc.logit_softcap, pc.embed_scale, pc.prefix_lm,
          pc.frontend),
         ("moe", ("attn",), False, False, 0.0, 0.0, False, False, "none"))]
    if lay.dense:
        out.append(("intermediate_size", lay.F, m.first_dense_ff or pc.d_ff))
    gap = probe_gap(cfg, pc)
    out.append(("norm_topk_prob, capacity_factor, aux_loss_alpha, seq_aux, "
                "router_z_loss_coef: the training loss at a probe's size, "
                "the port's against the reference's", "within the tolerance",
                "within the tolerance" if gap <= PROBE_TOL
                else f"{gap:.3e} apart"))
    return out


def probe_gap(cfg: dict, pc) -> float:
    """The relative gap of the port's training loss to the reference's,
    in f32 on the CPU, at ``PROBE_SIZES`` with two MoE layers, on rows
    that route evenly and rows of one repeated token, which send every
    token to the same experts and so over any capacity."""
    from repro_torch.models import Model

    from benchlib import weights
    from reference import common, moe_decoder as ref
    K = Layout(cfg).dense
    c = dict(cfg, num_hidden_layers=K + 2, **PROBE_SIZES)
    c.pop("head_dim", None)
    p = pc.replace(
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=0,
        d_ff=c["moe_intermediate_size"], vocab=c["vocab_size"],
        n_layers=K + 2, param_dtype="float32", compute_dtype="float32",
        moe=dataclasses.replace(pc.moe,
                                first_dense_ff=c["intermediate_size"]))
    gen = torch.Generator().manual_seed(0)
    V, S = c["vocab_size"], PROBE_SEQ
    tokens = torch.randint(0, V, (PROBE_ROWS, S), generator=gen)
    tokens[PROBE_ROWS // 2:] = torch.arange(PROBE_ROWS // 2)[:, None] + 1
    targets = torch.randint(0, V, (PROBE_ROWS, S), generator=gen)
    w = weights.stacked(c, 0, "cpu", torch.float32)
    with torch.no_grad(), common.f32_exact():
        port, _ = Model(p).loss_fn(port_tree(c, w),
                                   {"tokens": tokens, "targets": targets},
                                   remat="none", z_coef=0.0)
        want = ref.Model(c, w).loss(tokens, targets, 0.0)
    return float(abs(port - want) / abs(want))


# ---------------------------------------------------------------------------
# useful operations (counts.model)
# ---------------------------------------------------------------------------
def multiplied_params(cfg: dict) -> float:
    """The parameters a token multiplies: every layer's attention, the
    dense layers' MLP, and in each MoE layer the router, the k routed
    experts it is sent to and the shared experts; the head."""
    lay = Layout(cfg)
    expert = 3 * lay.d * lay.f
    moe = lay.d * lay.E + (lay.k + lay.shared) * expert
    return float(lay.L * decoder.attn_params(cfg)
                 + lay.dense * 3 * lay.d * lay.F + lay.moe_layers * moe
                 + lay.d * lay.V)


def decays(cfg: dict, w: Dict[str, torch.Tensor]):
    """The port's AdamW decays a tensor of two or more dimensions as the
    reference lays it out, which stacks the layers after the leading
    dense ones: so a norm scale decays in an MoE layer and not in a dense
    one."""
    lay = Layout(cfg)
    layers = torch.tensor([0.0] * lay.dense + [1.0] * lay.moe_layers,
                          device=w["norm1"].device).view(-1, 1)

    def rule(name):
        if name in ("norm1", "norm2"):
            return layers
        return 1.0 if w[name].ndim > 1 else 0.0
    return rule


def tiny(cfg: dict) -> dict:
    """The file cut to the port's reduced variant of its architecture."""
    from repro_torch import configs
    r = configs.reduced(cfg["port"]["arch"])
    m = r.moe
    return dict(cfg, port=dict(cfg["port"], preset="reduced"),
                moe_intermediate_size=r.d_ff, n_routed_experts=m.num_experts,
                num_experts_per_tok=m.top_k,
                n_shared_experts=m.num_shared_experts,
                first_k_dense_replace=int(m.first_layer_dense),
                intermediate_size=m.first_dense_ff or r.d_ff,
                **decoder.reduced_sizes(r))
