"""The dense decoder family (``reference: decoder``): pre-norm attention
blocks with a SwiGLU MLP, as ``reference/decoder.py`` models them.

The weights are one tensor per kind of leaf, stacked over the layers:
the attention projections and their biases, the feed-forward layers, the
norms; a projection at 1/sqrt(fan-in), a bias at ``BIAS_STD``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from reference.decoder import Layout

# a bias at half the spread of its projection's output (about 1 over
# normed rows), so that the bias path carries weight in the comparison
BIAS_STD = 0.5

# the limits of a cell of this family cut to CPU size (``benchtiny``),
# between the reduced model's sound readings (grad 4.2e-3, change 2.8e-3)
# and the float8 control's (2.5e-2, 7.1e-3) on the tests' seed; the loss
# gap is not compared, as in a cell's own limits
TINY_LIMITS = {"grad_gap": 1.2e-2, "change_gap": 5e-3}


def attn_shapes(lay) -> List[tuple]:
    """(name, shape, scale) of the embedding, the untied head and each
    layer's attention projections and biases, in draw order: the first
    draws of every decoder family."""
    d, H, Hkv, D, V, L = lay.d, lay.H, lay.Hkv, lay.D, lay.V, lay.L
    out = [("embedding", (V, d), d ** -0.5)]
    if not lay.tied:
        out.append(("head", (d, V), d ** -0.5))
    out += [("wq", (L, d, H, D), d ** -0.5),
            ("wk", (L, d, Hkv, D), d ** -0.5),
            ("wv", (L, d, Hkv, D), d ** -0.5),
            ("wo", (L, H, D, d), (H * D) ** -0.5)]
    if lay.bias:
        out += [("bq", (L, H, D), BIAS_STD), ("bk", (L, Hkv, D), BIAS_STD),
                ("bv", (L, Hkv, D), BIAS_STD)]
    return out


def shapes(cfg: dict) -> List[tuple]:
    """(name, shape, scale) of each stacked tensor, in draw order; a
    scale of 0 marks a norm's scale (ones)."""
    lay = Layout(cfg)
    d, L, F = lay.d, lay.L, lay.F
    return attn_shapes(lay) + [
        ("mlp_wi_gate", (L, d, F), d ** -0.5),
        ("mlp_wi_up", (L, d, F), d ** -0.5),
        ("mlp_wo", (L, F, d), F ** -0.5),
        ("norm1", (L, d), 0), ("norm2", (L, d), 0),
        ("final_norm", (d,), 0)]


def attn_tree(lay, w: Dict[str, torch.Tensor], i: int) -> dict:
    """Layer ``i``'s attention leaves in the port's tree."""
    names = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv") if lay.bias
                                        else ())
    return {n: w[n][i] for n in names}


def embed_tree(lay, w: Dict[str, torch.Tensor]) -> dict:
    embed = {"embedding": w["embedding"]}
    if not lay.tied:
        embed["head"] = w["head"]
    return embed


def port_tree(cfg: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree (``repro_torch.models.transformer``'s
    layout), each leaf a view of ``w``."""
    lay = Layout(cfg)
    layers = [{"norm1": w["norm1"][i], "norm2": w["norm2"][i],
               "attn": attn_tree(lay, w, i),
               "mlp": {n: w[f"mlp_{n}"][i]
                       for n in ("wi_gate", "wi_up", "wo")}}
              for i in range(lay.L)]
    return {"embed": embed_tree(lay, w), "layers": layers,
            "final_norm": w["final_norm"]}


def attn_checks(cfg: dict, pc) -> list:
    """(key, file's value, port's value) for the attention, the
    embedding and the norms, which every decoder family states alike."""
    lay = Layout(cfg)
    return [("hidden_size", cfg["hidden_size"], pc.d_model),
            ("num_attention_heads", cfg["num_attention_heads"], pc.n_heads),
            ("num_key_value_heads", cfg["num_key_value_heads"],
             pc.n_kv_heads),
            ("head_dim", lay.D, pc.hd),
            ("num_hidden_layers", cfg["num_hidden_layers"], pc.n_layers),
            ("vocab_size", cfg["vocab_size"], pc.vocab),
            ("rope_theta", float(cfg["rope_theta"]), float(pc.rope_theta)),
            ("rms_norm_eps", float(cfg["rms_norm_eps"]), float(pc.norm_eps)),
            ("tie_word_embeddings", bool(cfg.get("tie_word_embeddings")),
             pc.tie_embeddings),
            ("attention_bias", bool(cfg.get("attention_bias")),
             pc.qkv_bias),
            ("hidden_act", cfg.get("hidden_act", "silu"),
             {"swiglu": "silu"}.get(pc.mlp, pc.mlp))]


def port_checks(cfg: dict, pc) -> list:
    """(key, file's value, port's value) for every key the file states,
    and that the port's model is one the reference models: a dense
    decoder of pre-norm attention blocks."""
    return attn_checks(cfg, pc) + [
        ("intermediate_size", cfg["intermediate_size"], pc.d_ff),
        # what the reference's decoder does not model, the port's
        # config must not switch on
        ("dense pre-norm attention blocks",
         (pc.family, pc.period, pc.parallel_block, pc.moe.num_experts,
          pc.qk_norm, pc.attn_softcap, pc.logit_softcap,
          pc.embed_scale, pc.prefix_lm, pc.frontend),
         ("dense", ("attn",), False, 0, False, 0.0, 0.0, False, False,
          "none"))]


# ---------------------------------------------------------------------------
# useful operations (counts.model): 2 a multiply-add; a bias's adds are
# not counted
# ---------------------------------------------------------------------------
def attn_params(cfg: dict) -> float:
    """A layer's attention projections: q, k, v and the output."""
    lay = Layout(cfg)
    return float(lay.d * (lay.H + 2 * lay.Hkv) * lay.D + lay.H * lay.D * lay.d)


def body_params(cfg: dict) -> float:
    """The parameters a token multiplies in the layers (not the head):
    the attention projections and the SwiGLU MLP."""
    lay = Layout(cfg)
    return float(lay.L * (attn_params(cfg) + 3 * lay.d * lay.F))


def head_params(cfg: dict) -> float:
    return float(cfg["hidden_size"] * cfg["vocab_size"])


def multiplied_params(cfg: dict) -> float:
    return body_params(cfg) + head_params(cfg)


def attn_pair_flops(cfg: dict) -> float:
    """Operations of one visible (query, key) pair over every layer's
    heads (Q·Kᵀ and P·V)."""
    lay = Layout(cfg)
    return 4.0 * lay.H * lay.D * lay.L


def decays(cfg: dict, w: Dict[str, torch.Tensor]):
    """The port's AdamW decays a tensor of two or more dimensions, and
    the layers' norm scales, which the reference scans as one stack."""
    def rule(name):
        return 1.0 if name in ("norm1", "norm2") or w[name].ndim > 1 \
            else 0.0
    return rule


def reduced_sizes(r) -> dict:
    """The attention and embedding keys of the port's reduced config
    ``r``."""
    return dict(hidden_size=r.d_model, num_attention_heads=r.n_heads,
                num_key_value_heads=r.n_kv_heads, vocab_size=r.vocab,
                num_hidden_layers=r.n_layers)


def tiny(cfg: dict) -> dict:
    """The file cut to the port's reduced variant of its architecture."""
    from repro_torch import configs
    r = configs.reduced(cfg["port"]["arch"])
    return dict(cfg, port=dict(cfg["port"], preset="reduced"),
                intermediate_size=r.d_ff, **reduced_sizes(r))
