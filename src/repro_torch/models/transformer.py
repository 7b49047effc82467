"""The attention-family ``Model``: prefill, prefill chunk, decode step and
cache specs, ported from ``src/repro/models/transformer.py``.

Parameters are a plain dict::

    {"embed": {"embedding": (V, d)[, "head": (d, V)]},
     "layers": [per-layer dict, ...],          # n_layers, in order
     "final_norm": (d,)}

and the KV cache is ``{"k": (layers, B, T, Hkv, D), "v": ...}``.  The
reference's scan over layer *periods* is a plain loop over ``layers``
here; ``bridge.params_from_numpy`` unstacks the reference's periods.

``prefill`` returns a fresh cache; ``prefill_chunk`` and ``decode_step``
write the new K/V in place into the cache they are given and return it.

Only attention-family blocks are ported so far: MoE, the recurrent
families, encoder-decoder and VLM configs raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ATTN_KINDS, ModelConfig
from .attention import (attn_decode, attn_params, attn_prefill,
                        attn_prefill_chunk)
from .common import (dtype_of, embed_params, embed_tokens, mlp, mlp_params,
                     ones_init, resolve_device, rms_norm, unembed)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run yet,
    naming the ROADMAP item that ports it."""
    if cfg.moe.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE blocks are not ported yet (ROADMAP A7, B3)")
    kinds = {cfg.kind_at(i) for i in range(cfg.n_layers)}
    if not kinds <= set(ATTN_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: {sorted(kinds - set(ATTN_KINDS))} blocks are not "
            f"ported yet (ROADMAP A8, B4, B5)")
    if cfg.n_enc_layers or cfg.frontend != "none" or cfg.prefix_lm:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and VLM models are not ported "
            f"yet (ROADMAP A6)")


class Model:
    """One attention-family architecture, parameterized by its config."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg
        self.kinds = tuple(cfg.kind_at(i) for i in range(cfg.n_layers))

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, *, device="cuda") -> dict:
        """Seeded random weights on ``device``."""
        cfg = self.cfg
        gen = torch.Generator(device=resolve_device(device))
        gen.manual_seed(seed)
        dt = dtype_of(cfg.param_dtype)
        embed = embed_params(cfg, gen)
        layers = []
        for _ in self.kinds:
            p = {"norm1": ones_init(gen, (cfg.d_model,), dt),
                 "attn": attn_params(cfg, gen),
                 "mlp": mlp_params(cfg, gen)}
            if not cfg.parallel_block:
                p["norm2"] = ones_init(gen, (cfg.d_model,), dt)
            layers.append(p)
        return {"embed": embed, "layers": layers,
                "final_norm": ones_init(gen, (cfg.d_model,), dt)}

    # ----------------------------------------------------------------- block
    def _block(self, p: dict, x, mix):
        """One pre-norm block; ``mix(attn_params, h)`` is the attention
        half (prefill, chunk or decode)."""
        cfg = self.cfg
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        a = mix(p["attn"], h)
        if cfg.parallel_block:
            return x + a + mlp(cfg, p["mlp"], h)
        x = x + a
        return x + mlp(cfg, p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps))

    def _final(self, params, h):
        return rms_norm(h, params["final_norm"], self.cfg.norm_eps)

    # ------------------------------------------------------------------ serve
    def prefill(self, params, tokens, *, cache_len: Optional[int] = None):
        """Prompt pass over tokens (B,S). Returns (last-position logits
        (B,V) f32, cache of length ``cache_len`` in the compute dtype)."""
        cfg = self.cfg
        B, S = tokens.shape
        h = embed_tokens(cfg, params["embed"], tokens)
        cache = self.cache_specs(B, cache_len or S,
                                 dtype=dtype_of(cfg.compute_dtype),
                                 device=tokens.device)
        for i, (p, kind) in enumerate(zip(params["layers"], self.kinds)):
            h = self._block(p, h, lambda a, x: attn_prefill(
                cfg, a, x, cache["k"][i], cache["v"][i], kind=kind))
        return unembed(cfg, params["embed"], self._final(params, h)[:, -1]), \
            cache

    def prefill_chunk(self, params, cache, tokens, offset: int):
        """One prefill chunk: tokens (B,C) at absolute positions
        ``offset..offset+C-1`` of an existing full-length cache.  Returns
        (logits (B,C,V), cache)."""
        cfg = self.cfg
        h = embed_tokens(cfg, params["embed"], tokens)
        for i, (p, kind) in enumerate(zip(params["layers"], self.kinds)):
            h = self._block(p, h, lambda a, x: attn_prefill_chunk(
                cfg, a, x, cache["k"][i], cache["v"][i], offset, kind=kind))
        return unembed(cfg, params["embed"], self._final(params, h)), cache

    def decode_step(self, params, cache, tokens, pos):
        """One token per row: tokens (B,1); ``pos`` a scalar or a (B,)
        tensor. Returns (logits (B,V), cache)."""
        cfg = self.cfg
        h = embed_tokens(cfg, params["embed"], tokens)
        for i, (p, kind) in enumerate(zip(params["layers"], self.kinds)):
            h = self._block(p, h, lambda a, x: attn_decode(
                cfg, a, x, cache["k"][i], cache["v"][i], pos, kind=kind))
        return unembed(cfg, params["embed"], self._final(params, h))[:, 0], \
            cache

    @property
    def supports_chunked_prefill(self) -> bool:
        """Every config the port accepts is attention-only and continues a
        prefill at an offset."""
        return True

    # ------------------------------------------------------------------ specs
    def cache_specs(self, batch_size: int, cache_len: int, *,
                    dtype=torch.bfloat16, device="cuda") -> dict:
        """Zeroed KV cache, {"k", "v"}: (layers, B, T, Hkv, D)."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, cache_len, cfg.n_kv_heads, cfg.hd)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
