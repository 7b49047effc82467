"""The port's ``ModelConfig`` for a configuration file, and a check that
the two state the same model.

A configuration file holds its source's keys (Hugging Face names) as the
cell runs them, and under ``port`` the port's name for the architecture
and the dtypes it is served or trained in (``preset: reduced`` takes the
port's small CPU variant of it, for the benchmark's own tests).  ``port_config`` takes the
port's published config of that name, sets the depth and dtypes, and
fails unless every size and every stated rule the file gives is the
port's, and the port's model is one the reference models (a dense
decoder of pre-norm attention blocks): a file that says one model while
the port runs another is refused before any run.
"""
from __future__ import annotations

from .weights import Layout


def _checks(cfg: dict, pc) -> list:
    """(key, file's value, port's value) for every key the file states."""
    lay = Layout(cfg)
    return [("hidden_size", cfg["hidden_size"], pc.d_model),
            ("num_attention_heads", cfg["num_attention_heads"], pc.n_heads),
            ("num_key_value_heads", cfg["num_key_value_heads"],
             pc.n_kv_heads),
            ("head_dim", lay.D, pc.hd),
            ("num_hidden_layers", cfg["num_hidden_layers"], pc.n_layers),
            ("intermediate_size", cfg["intermediate_size"], pc.d_ff),
            ("vocab_size", cfg["vocab_size"], pc.vocab),
            ("rope_theta", float(cfg["rope_theta"]), float(pc.rope_theta)),
            ("rms_norm_eps", float(cfg["rms_norm_eps"]), float(pc.norm_eps)),
            ("tie_word_embeddings", bool(cfg.get("tie_word_embeddings")),
             pc.tie_embeddings),
            ("attention_bias", bool(cfg.get("attention_bias")),
             pc.qkv_bias),
            ("hidden_act", cfg.get("hidden_act", "silu"),
             {"swiglu": "silu"}.get(pc.mlp, pc.mlp)),
            # what the reference's decoder does not model, the port's
            # config must not switch on
            ("dense pre-norm attention blocks",
             (pc.family, pc.period, pc.parallel_block, pc.moe.num_experts,
              pc.qk_norm, pc.attn_softcap, pc.logit_softcap,
              pc.embed_scale, pc.prefix_lm, pc.frontend),
             ("dense", ("attn",), False, 0, False, 0.0, 0.0, False, False,
              "none"))]


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for the configuration file ``cfg``."""
    from repro_torch import configs
    port = cfg["port"]
    base = (configs.reduced if port.get("preset") == "reduced"
            else configs.get)(port["arch"])
    pc = base.replace(
        n_layers=cfg["num_hidden_layers"],
        param_dtype=port["param_dtype"],
        compute_dtype=port["compute_dtype"])
    wrong = [(k, a, b) for k, a, b in _checks(cfg, pc) if a != b]
    if wrong:
        raise ValueError(f"{cfg['name']}: the file and the port's "
                         f"{port['arch']} differ: {wrong}")
    return pc
