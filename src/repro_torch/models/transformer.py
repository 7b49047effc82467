"""The ``Model``: the training loss, prefill, prefill chunk, decode step
and cache specs, ported from ``src/repro/models/transformer.py``.

Parameters are a plain dict::

    {"embed": {"embedding": (V, d)[, "head": (d, V)]
               [, "frontend_proj": (frontend_dim, d)]},
     "layers": [per-layer dict, ...],          # n_layers, in order
     "final_norm": (d,)
     [, "encoder": {"layers": [...], "final_norm": (d,)}]}

The reference's scan over layer *periods* is a plain loop over
``layers`` here; ``bridge.params_from_numpy`` unstacks the reference's
periods.

A layer is an attention block (``"attn"``: attn, local, global) or a
recurrent one (``"rec"``: Mamba2 SSD, ``models/ssd_block.py``, or RG-LRU,
``models/rglru_block.py``).  The cache holds one stack per kind of
state, with the batch on dim 1, and each layer keeps its index into its
kind's stack (``Model.cache_index``)::

    "k", "v"                  (attention layers, B, T, Hkv, D)
    "ssd_h"                   (SSD layers, B, H, P, N) f32
    "ssd_conv"                (SSD layers, B, cw-1, conv channels)
    "rglru_h"                 (RG-LRU layers, B, W) f32
    "rglru_conv"              (RG-LRU layers, B, cw-1, W)
    "cross_k", "cross_v"      (decoder layers of an encoder-decoder,
                               B, frontend_seq, Hkv, D)

Only the stacks of kinds the model has are present.  The recurrent ``h``
stays f32 whatever the cache dtype is, as in the reference.

``prefill`` returns a fresh cache; ``prefill_chunk`` and ``decode_step``
write the new K/V and states in place into the cache they are given and
return it.  A model with a recurrent layer cannot chunk its prefill: its
state carries no resumable prefill (``supports_chunked_prefill``).

A layer's feed-forward half is a dense MLP (``"mlp"``) or, for MoE
configs, an MoE layer (``"moe"``, ``models/moe.py``); deepseek's dense
first layer keeps an MLP of ``first_dense_ff``.  Serving runs MoE layers
dropless and discards their aux losses, as the reference does.

``loss_fn`` is the teacher-forced LM loss of training (the reference's
``loss_fn``) for attention, MoE, SSD and RG-LRU layers: MoE layers run at
the config's capacity factor and add their aux losses (``AUX_KEYS``) to
the loss; the recurrent layers train through their prefill algebra, the
scans' autograd Functions carrying the gradients.

**Frontends.**  A config with a ``frontend`` takes precomputed
embeddings (B, F, frontend_dim) beside the tokens, projected by
``embed.frontend_proj`` (the reference stubs the vision and audio
towers the same way).  A VLM (``family == "vlm"``) puts the projected
patches before the text; under ``prefix_lm`` every query sees all F
patches (``prefix_len = frontend_seq``) and the text stays causal.  An
encoder-decoder (``n_enc_layers``) runs its frames through the encoder,
``n_enc_layers`` non-causal attention blocks with RoPE at positions
0..F-1 and a final norm; every decoder layer then attends to that memory
(``cross``, after its self-attention and before its MLP) through K/V it
projects once, which prefill keeps in the cache (``cross_k``/``cross_v``)
for decode.  Neither kind chunks its prefill, as in the reference.

**Serving on a mesh** (``prefill`` / ``decode_step`` with
``spmd=TensorParallel``, forward only).  The parameters are the rank's
stored blocks, each layer's leaves gathered over the data axes as it
runs; the tokens are the rank's rows (split over ``spmd.batch_axes``);
the cache is the rank's blocks of ``cache_axes``' tree as ``tree_specs``
places it under ``spmd.rules`` (``serve_layout``): K/V split along the
positions over the model axis (over (data, model) under ``long_500k``'s
rule), recurrent states at the rank's heads or channels, an SSD conv
tail whole, cross K/V at the rank's heads where the model axis divides
them.  Sub-layers compute on the rank's share as in training; decode
attention over positions split across ranks is ``sp_decode_attention``;
the logits are vocabulary-parallel, then gathered whole (B, V).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ATTN_KINDS, ModelConfig
from .attention import (KVLayout, attn_axes, attn_decode, attn_params,
                        attn_prefill, attn_prefill_chunk, attn_train,
                        cross_attn, cross_kv, kv_heads_read)
from .common import (ShapesOnly, chunked_ce_loss, dtype_of, embed_axes,
                     embed_params, embed_tokens, mlp, mlp_axes, mlp_params,
                     ones_init, resolve_device, rms_norm, unembed)
from ..distrib.collectives import all_gather_dim
from ..distrib.sharding import block_shape, entry_axes, tree_specs
from ..distrib.tensor_parallel import TensorParallel
from .moe import moe_apply, moe_axes, moe_params, padded_experts
from .rglru_block import (rglru_axes, rglru_block_apply, rglru_block_decode,
                          rglru_cache_spec, rglru_params)
from .ssd_block import (ssd_axes, ssd_block_apply, ssd_block_decode,
                        ssd_cache_spec, ssd_params, whole_conv_tail)


AUX_KEYS = ("moe_lb", "moe_z")


class _Recurrent(NamedTuple):
    """One recurrent block kind's functions."""
    params: Callable
    prefill: Callable
    decode: Callable
    cache_spec: Callable
    axes: Callable


_RECURRENT = {
    "ssd": _Recurrent(ssd_params, ssd_block_apply, ssd_block_decode,
                      ssd_cache_spec, ssd_axes),
    "rglru": _Recurrent(rglru_params, rglru_block_apply, rglru_block_decode,
                        rglru_cache_spec, rglru_axes),
}


def _group(kind: str) -> str:
    """The cache stack a layer of ``kind`` keeps its state in."""
    return "attn" if kind in ATTN_KINDS else kind


def _gather(tp: Optional[TensorParallel], part, where):
    """``part`` (at ``where`` in the parameters) ready for compute: as it
    is without a mesh, gathered by ``tp`` with one."""
    return part if tp is None else tp.gather(part, where)


def _split(tp: Optional[TensorParallel], where, sub: str):
    """The ``Split`` of the sub-layer ``sub`` at ``where``, or None."""
    return None if tp is None else tp.split(tuple(where) + (sub,))


def _on_stream(tp: Optional[TensorParallel], leaf):
    """A norm's weight as the residual stream's layout applies it."""
    return leaf if tp is None else tp.on_stream(leaf)


class Model:
    """One architecture, parameterized by its config."""

    def __init__(self, cfg: ModelConfig, e_pad: Optional[int] = None):
        self.cfg = cfg
        self.is_encdec = cfg.n_enc_layers > 0
        self.kinds = tuple(cfg.kind_at(i) for i in range(cfg.n_layers))
        # layer i's index into the cache stack of its kind
        self.cache_index = []
        self.stack_sizes = {}
        for kind in self.kinds:
            g = _group(kind)
            self.cache_index.append(self.stack_sizes.get(g, 0))
            self.stack_sizes[g] = self.cache_index[-1] + 1
        # deepseek: layer 0 is a dense FFN (the reference's "prefix")
        self.prefix_count = 1 if (cfg.moe.first_layer_dense
                                  and cfg.moe.num_experts) else 0
        # experts padded to a multiple of the expert shards (the router
        # masks the padded ones), as the reference's ``e_pad``
        self.e_pad = e_pad or (padded_experts(cfg, 1)
                               if cfg.moe.num_experts else None)

    def stacked_layers(self) -> list:
        """The layers whose weights the reference holds stacked along a
        leading axis: for each position in the period (its scan over
        periods) one list of ("layers", index) pairs, indices into
        ``params["layers"]``, and for an encoder-decoder one list of
        ("encoder", index) pairs (its ``encoder.stack``), indices into
        ``params["encoder"]["layers"]``."""
        plen = len(self.cfg.period)
        n_scan = (self.cfg.n_layers - self.prefix_count) // plen
        groups = [[("layers", self.prefix_count + j * plen + pos)
                   for j in range(n_scan)]
                  for pos in range(plen)] if n_scan else []
        if self.is_encdec:
            groups.append([("encoder", i)
                           for i in range(self.cfg.n_enc_layers)])
        return groups

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0, *, device="cuda",
             keep: Optional[Callable] = None) -> dict:
        """Seeded random weights on ``device``; on ``"meta"`` the same tree
        of meta tensors (shapes and dtypes, nothing allocated).

        ``keep(path, part)``, where given, is applied to each part of the
        tree as soon as it is drawn (the embedding, each layer, each final
        norm; ``path`` the part's keys from the root) and its result is
        kept in the part's place: a sharded state keeps only its blocks,
        so no more than one part is ever held whole.  It draws nothing,
        so the weights are the same with it or without."""
        cfg = self.cfg
        if keep is None:
            def keep(path, part):
                return part
        dev = resolve_device(device)
        if dev.type == "meta":
            gen = ShapesOnly()
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        dt = dtype_of(cfg.param_dtype)
        embed = keep(("embed",), embed_params(cfg, gen))
        layers = []
        for i, kind in enumerate(self.kinds):
            p = {"norm1": ones_init(gen, (cfg.d_model,), dt)}
            if kind in ATTN_KINDS:
                p["attn"] = attn_params(cfg, gen)
            else:
                p["rec"] = _RECURRENT[kind].params(cfg, gen)
            # the feed-forward half (SSD blocks have none: d_ff == 0)
            if i < self.prefix_count:
                p["mlp"] = mlp_params(
                    cfg, gen, d_ff=cfg.moe.first_dense_ff or cfg.d_ff)
            elif cfg.d_ff > 0 and cfg.moe.num_experts:
                p["moe"] = moe_params(cfg, gen, e_pad=self.e_pad)
            elif cfg.d_ff > 0:
                p["mlp"] = mlp_params(cfg, gen)
            if self.is_encdec:
                p["cross_norm"] = ones_init(gen, (cfg.d_model,), dt)
                p["cross"] = attn_params(cfg, gen)
            if ("mlp" in p or "moe" in p) and not cfg.parallel_block:
                p["norm2"] = ones_init(gen, (cfg.d_model,), dt)
            layers.append(keep(("layers", i), p))
        params = {"embed": embed, "layers": layers,
                  "final_norm": keep(("final_norm",),
                                     ones_init(gen, (cfg.d_model,), dt))}
        if self.is_encdec:
            enc = [keep(("encoder", "layers", i),
                        {"norm1": ones_init(gen, (cfg.d_model,), dt),
                         "attn": attn_params(cfg, gen),
                         "mlp": mlp_params(cfg, gen),
                         "norm2": ones_init(gen, (cfg.d_model,), dt)})
                   for i in range(cfg.n_enc_layers)]
            params["encoder"] = {
                "layers": enc,
                "final_norm": keep(("encoder", "final_norm"),
                                   ones_init(gen, (cfg.d_model,), dt))}
        return params

    def param_axes(self) -> dict:
        """A tree shaped like ``init``'s whose leaves are the logical axes
        the reference tags each parameter with (``dense_p`` / ``P``),
        less the leading ``"layers"`` of its stacked layers: the port
        keeps each layer apart."""
        cfg = self.cfg
        embed = ("embed",)
        layers = []
        for i, kind in enumerate(self.kinds):
            p = {"norm1": embed}
            if kind in ATTN_KINDS:
                p["attn"] = attn_axes(cfg)
            else:
                p["rec"] = _RECURRENT[kind].axes(cfg)
            if i < self.prefix_count or (cfg.d_ff > 0
                                         and not cfg.moe.num_experts):
                p["mlp"] = mlp_axes(cfg)
            elif cfg.d_ff > 0:
                p["moe"] = moe_axes(cfg)
            if self.is_encdec:
                p["cross_norm"] = embed
                p["cross"] = attn_axes(cfg)
            if ("mlp" in p or "moe" in p) and not cfg.parallel_block:
                p["norm2"] = embed
            layers.append(p)
        axes = {"embed": embed_axes(cfg), "layers": layers,
                "final_norm": embed}
        if self.is_encdec:
            enc = {"norm1": embed, "attn": attn_axes(cfg),
                   "mlp": mlp_axes(cfg), "norm2": embed}
            axes["encoder"] = {"layers": [enc] * cfg.n_enc_layers,
                               "final_norm": embed}
        return axes

    # ----------------------------------------------------------------- block
    def _ffn(self, p: dict, h, aux: Optional[dict] = None,
             tp: Optional[TensorParallel] = None, where=(), split=None,
             cf: Optional[float] = None):
        """The feed-forward half.  Serving (``aux`` None) runs MoE layers
        dropless, or at the capacity factor ``cf`` where given, and drops
        their aux losses; training runs them at the config's capacity
        factor and adds their aux losses to ``aux``; ``tp`` lays the
        layer at ``where`` out on a mesh: an MLP in tensor parallel where
        its leaves are split (``split``, where given, in place of its own
        ``Split``), MoE layers through ``tp.moe`` (``models/moe.py``)."""
        if "moe" in p:
            y, a = moe_apply(self.cfg, p["moe"], h,
                             spmd=tp.moe if tp is not None else None,
                             capacity_factor=cf,
                             dropless=aux is None and cf is None,
                             want_aux=aux is not None)
            if aux is not None:
                for key in AUX_KEYS:
                    aux[key] = aux[key] + a[key]
            return y
        return mlp(self.cfg, p["mlp"], h,
                   tp=split or _split(tp, where, "mlp"))

    def _block(self, p: dict, x, mix, aux: Optional[dict] = None,
               mem_kv=None, tp: Optional[TensorParallel] = None, where=(),
               cf: Optional[float] = None):
        """One pre-norm block; ``mix(h)`` is the mixing half (attention
        or recurrence; training, prefill, chunk or decode); ``aux``,
        ``tp`` and ``where`` as ``_ffn``'s; ``mem_kv``, the cross
        attention's (K, V) of an encoder-decoder layer, is attended to
        after the mixing half.  Under ``tp`` the norms' weights pass
        ``tp.on_stream``; a parallel block whose attention and MLP the
        model axis both splits enters its input once and sums the two
        halves' partials in one exit, ``mix(h, split=)`` then taking the
        fused ``Split``."""
        cfg = self.cfg
        h = rms_norm(x, _on_stream(tp, p["norm1"]), cfg.norm_eps)
        if cfg.parallel_block and ("mlp" in p or "moe" in p):
            both = (_split(tp, where, "attn" if "attn" in p else "rec")
                    if "mlp" in p else None)
            if both is not None and _split(tp, where, "mlp") is not None:
                hh, inner = both.enter(h), both.fused()
                return x + both.leave(mix(hh, split=inner) + self._ffn(
                    p, hh, aux, tp, where, split=inner, cf=cf))
            return x + mix(h) + self._ffn(p, h, aux, tp, where, cf=cf)
        a = mix(h)
        x = x + a
        if mem_kv is not None:
            x = x + cross_attn(cfg, p["cross"],
                               rms_norm(x, p["cross_norm"], cfg.norm_eps),
                               *mem_kv, tp=_split(tp, where, "cross"))
        if "mlp" not in p and "moe" not in p:
            return x
        return x + self._ffn(p, rms_norm(x, _on_stream(tp, p["norm2"]),
                                         cfg.norm_eps), aux, tp, where,
                             cf=cf)

    def _embed_inputs(self, emb, tokens, frontend=None, tp=None):
        """(h, prefix_len): the token embeddings (``emb``: the embedding
        part of the parameters; ``tp`` the vocabulary's ``Split``, or
        None), and for a VLM with a frontend the projected patches
        (B,F,d) before them, under ``prefix_lm`` with ``prefix_len`` = F
        (the patches; the text stays causal)."""
        cfg = self.cfg
        h = embed_tokens(cfg, emb, tokens, tp=tp)
        if cfg.family != "vlm" or frontend is None:
            return h, None
        patches = self._project_frontend(emb, frontend)
        return (torch.cat([patches, h], dim=1),
                cfg.frontend_seq if cfg.prefix_lm else None)

    def _project_frontend(self, emb, frontend):
        cdt = dtype_of(self.cfg.compute_dtype)
        return frontend.to(cdt) @ emb["frontend_proj"].to(cdt)

    def _encode(self, params, emb, frontend, remat: str = "none",
                tp: Optional[TensorParallel] = None):
        """The encoder: frames (B,F,frontend_dim) → memory (B,F,d), each
        layer a non-causal self-attention block (RoPE at 0..F-1) and
        its MLP, then the encoder's final norm.  ``remat`` and ``tp`` as
        ``loss_fn``'s (``emb``: the embedding part, gathered)."""
        cfg = self.cfg
        if frontend is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: it takes "
                             f"a frontend (frames) beside the tokens")

        def layer(p, h, where):
            p = _gather(tp, p, where)
            return self._block(p, h, lambda x: attn_train(
                cfg, p["attn"], x, causal=False,
                tp=_split(tp, where, "attn")), tp=tp, where=where)

        h = self._project_frontend(emb, frontend)
        for i, p in enumerate(params["encoder"]["layers"]):
            where = ("encoder", "layers", i)
            h = (checkpoint(layer, p, h, where, use_reentrant=False)
                 if remat == "block" else layer(p, h, where))
        norm = _gather(tp, params["encoder"]["final_norm"],
                       ("encoder", "final_norm"))
        return rms_norm(h, norm, cfg.norm_eps)

    def _final(self, params, h, tp: Optional[TensorParallel] = None):
        norm = _gather(tp, params["final_norm"], ("final_norm",))
        return rms_norm(h, _on_stream(tp, norm), self.cfg.norm_eps)

    # ------------------------------------------------------------------ train
    def loss_fn(self, params, batch, *, remat: str = "block",
                z_coef: float = 1e-4, ce_chunk: int = 512,
                spmd: Optional[TensorParallel] = None):
        """Teacher-forced LM loss, as the reference's ``loss_fn``.  batch:
        ``tokens`` and ``targets`` (B,S) (-1: no target), and a config
        with a frontend takes ``frontend`` (B,F,frontend_dim) (a VLM's
        targets then cover the F patches too: (B,F+S)).  ``remat``:
        ``"block"`` wraps each layer in ``torch.utils.checkpoint`` (its
        activations are recomputed in the backward; the reference wraps
        each period in ``jax.checkpoint``), ``"none"`` keeps them.  MoE
        layers drop over capacity (the config's capacity factor) and their
        aux losses, summed over the layers, join the loss.

        ``spmd`` (``distrib.tensor_parallel.TensorParallel``) runs the
        sharded step's layout: ``params`` are then this rank's stored
        blocks and the batch its tokens; each layer gathers its leaves
        over the data axes as it runs (again in its recompute under
        remat "block"), the embedding is gathered once for the lookup
        and the loss, and the sub-layers that the model axis splits
        compute in tensor parallel (the vocabulary-parallel loss is the
        same on every rank of the model axis); the MoE layers run
        expert-parallel (``spmd.moe``) and their aux losses are over
        every token of the mesh.  Where ``spmd.stream`` splits the
        residual stream over the sequence, each layer's input and output
        are this rank's S/n positions (so is the embedding's output: the
        vocabulary-parallel lookup reduce-scatters its sum, the
        whole-vocabulary one looks up this rank's tokens only), the final
        norm runs on them, and the loss on the hidden states put back
        together.
        Returns (loss, {"ce", "z_loss", "tokens", "moe_lb", "moe_z",
        "loss"})."""
        cfg = self.cfg
        tp = spmd
        if remat not in ("none", "block"):
            raise ValueError(f"remat {remat!r}: 'none' or 'block'")
        stream = None if tp is None else tp.stream
        if stream is not None:
            tp.check_seq_len(batch["tokens"].shape[1])

        def layer(p, h, kind, memory, where):
            p = _gather(tp, p, where)
            aux = {key: h.new_zeros((), dtype=torch.float32)
                   for key in AUX_KEYS}
            if kind in ATTN_KINDS:
                def mix(x, split=_split(tp, where, "attn")):
                    return attn_train(cfg, p["attn"], x, kind=kind,
                                      prefix_len=prefix_len, tp=split)
            else:
                def mix(x, split=_split(tp, where, "rec")):
                    return _RECURRENT[kind].prefill(cfg, p["rec"], x,
                                                    tp=split)[0]
            mem_kv = (None if memory is None
                      else cross_kv(cfg, p["cross"], memory,
                                    tp=_split(tp, where, "cross")))
            h = self._block(p, h, mix, aux, mem_kv, tp, where)
            return h, aux["moe_lb"], aux["moe_z"]

        frontend = batch.get("frontend")
        # the tied table serves the lookup and the loss: gathered once
        emb = _gather(tp, params["embed"], ("embed",))
        vocab = _split(tp, (), "embed")
        if stream is not None and vocab is None:
            # the whole vocabulary: this rank's positions looked up, the
            # table's partial gradient summed
            s = batch["tokens"].shape[1] // stream.n
            h, prefix_len = self._embed_inputs(
                dict(emb, embedding=stream.shared(emb["embedding"])),
                batch["tokens"][:, stream.rank * s:(stream.rank + 1) * s])
        else:
            h, prefix_len = self._embed_inputs(emb, batch["tokens"],
                                               frontend, tp=vocab)
        memory = (self._encode(params, emb, frontend, remat, tp)
                  if self.is_encdec else None)
        aux = [h.new_zeros((), dtype=torch.float32) for _ in AUX_KEYS]
        for i, (p, kind) in enumerate(zip(params["layers"], self.kinds)):
            where = ("layers", i)
            if remat == "block":
                h, *a = checkpoint(layer, p, h, kind, memory, where,
                                   use_reentrant=False)
            else:
                h, *a = layer(p, h, kind, memory, where)
            aux = [x + y for x, y in zip(aux, a)]
        h = self._final(params, h, tp)
        if stream is not None:
            h = stream.whole(h)
        loss, metrics = chunked_ce_loss(cfg, emb, h, batch["targets"],
                                        z_coef=z_coef, chunk=ce_chunk,
                                        tp=vocab)
        for key, value in zip(AUX_KEYS, aux):
            loss = loss + value
            metrics[key] = value
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------------ serve
    def prefill(self, params, tokens, *, cache_len: Optional[int] = None,
                frontend=None, spmd: Optional[TensorParallel] = None,
                capacity_factor: Optional[float] = None):
        """Prompt pass over tokens (B,S) (and ``frontend``
        (B,F,frontend_dim) for a config with one: a VLM's patches come
        first, F + S positions).  Returns (last-position logits (B,V)
        f32, cache of length ``cache_len``: K/V in the compute dtype,
        recurrent ``h`` in f32, conv tails in the compute dtype, an
        encoder-decoder's cross K/V in the compute dtype).  MoE layers
        run dropless, or at ``capacity_factor`` where given.

        ``spmd`` serves on a mesh (see the module docstring): ``params``
        are then this rank's stored blocks, ``tokens`` (and ``frontend``)
        its rows of the batch, and the cache returned is this rank's
        blocks (``serve_layout``); the MoE layers run expert-parallel
        (``spmd.moe``) and the logits are gathered whole (B, V)."""
        cfg = self.cfg
        tp = spmd
        B = tokens.shape[0]
        cdt = dtype_of(cfg.compute_dtype)
        emb, vocab = _gather(tp, params["embed"], ("embed",)), \
            _split(tp, (), "embed")
        h, prefix_len = self._embed_inputs(emb, tokens, frontend, tp=vocab)
        T = cache_len or h.shape[1]
        specs, layout, cross_split = self.serve_layout(tp, B, T)
        memory = (self._encode(params, emb, frontend, tp=tp)
                  if self.is_encdec else None)
        cache = self._zero_cache(specs, tp, B, T, memory, cdt, tokens.device)
        states = {g: [] for g in self.stack_sizes if g != "attn"}

        for i, (p, kind) in enumerate(zip(params["layers"], self.kinds)):
            where = ("layers", i)
            p = _gather(tp, p, where)
            j = self.cache_index[i]
            mem_kv = None
            if memory is not None:
                split = _split(tp, where, "cross")
                kv = cross_kv(cfg, p["cross"], memory,
                              tp=split if cross_split else None)
                cache["cross_k"][i], cache["cross_v"][i] = kv
                mem_kv = self._cross_read(p, kv, split, cross_split)
            if kind in ATTN_KINDS:
                def mix(x, split=_split(tp, where, "attn"), p=p, j=j,
                        kind=kind):
                    return attn_prefill(
                        cfg, p["attn"], x, cache["k"][j], cache["v"][j],
                        kind=kind, prefix_len=prefix_len, layout=layout,
                        tp=split)
            else:
                def mix(x, split=_split(tp, where, "rec"), p=p, kind=kind):
                    out, st = _RECURRENT[kind].prefill(
                        cfg, p["rec"], x, want_cache=True, tp=split)
                    if kind == "ssd" and split is not None:
                        st = dict(st, conv=whole_conv_tail(cfg, st["conv"],
                                                           split))
                    states[kind].append(st)
                    return out
            h = self._block(p, h, mix, mem_kv=mem_kv, tp=tp, where=where,
                            cf=capacity_factor)
        for g, sts in states.items():
            for name in ("h", "conv"):
                cache[f"{g}_{name}"] = torch.stack([st[name] for st in sts])
        return self._logits(params, emb, h[:, -1], tp, vocab), cache

    def prefill_chunk(self, params, cache, tokens, offset: int):
        """One prefill chunk: tokens (B,C) at absolute positions
        ``offset..offset+C-1`` of an existing full-length cache.  Returns
        (logits (B,C,V), cache).  Requires ``supports_chunked_prefill``."""
        if not self.supports_chunked_prefill:
            raise ValueError("chunked prefill requires attention-family "
                             "blocks (ssd and rglru carry no resumable "
                             "prefill state)")
        cfg = self.cfg
        h = embed_tokens(cfg, params["embed"], tokens)
        for i, (p, kind) in enumerate(zip(params["layers"], self.kinds)):
            h = self._block(p, h, lambda x: attn_prefill_chunk(
                cfg, p["attn"], x, cache["k"][i], cache["v"][i], offset,
                kind=kind))
        return unembed(cfg, params["embed"], self._final(params, h)), cache

    def decode_step(self, params, cache, tokens, pos, *,
                    spmd: Optional[TensorParallel] = None,
                    cache_len: Optional[int] = None):
        """One token per row: tokens (B,1); ``pos`` a scalar or a (B,)
        tensor. Returns (logits (B,V), cache), the cache updated in
        place.  ``spmd`` serves on a mesh: ``cache`` is then this rank's
        blocks (``prefill``'s) of one whose K/V hold ``cache_len``
        positions, ``tokens`` its rows; attention over K/V split along
        the positions runs ``sp_decode_attention``, the recurrent blocks
        step their rank's heads or channels."""
        cfg = self.cfg
        tp = spmd
        if tp is not None and "k" in cache and cache_len is None:
            raise ValueError("decode_step on a mesh: pass cache_len, the "
                             "whole cache's positions")
        specs, layout, cross_split = self.serve_layout(
            tp, tokens.shape[0], cache_len or 1)
        emb, vocab = _gather(tp, params["embed"], ("embed",)), \
            _split(tp, (), "embed")
        h = embed_tokens(cfg, emb, tokens, tp=vocab)

        for i, (p, kind) in enumerate(zip(params["layers"], self.kinds)):
            where = ("layers", i)
            p = _gather(tp, p, where)
            j = self.cache_index[i]
            mem_kv = None
            if self.is_encdec:
                mem_kv = self._cross_read(
                    p, (cache["cross_k"][i], cache["cross_v"][i]),
                    _split(tp, where, "cross"), cross_split)
            if kind in ATTN_KINDS:
                def mix(x, split=_split(tp, where, "attn"), p=p, j=j,
                        kind=kind):
                    return attn_decode(
                        cfg, p["attn"], x, cache["k"][j], cache["v"][j],
                        pos, kind=kind, layout=layout, tp=split)
            else:
                def mix(x, split=_split(tp, where, "rec"), p=p, j=j,
                        kind=kind):
                    h_, conv = cache[f"{kind}_h"][j], cache[f"{kind}_conv"][j]
                    out, st = _RECURRENT[kind].decode(
                        cfg, p["rec"], x, {"h": h_, "conv": conv}, tp=split)
                    h_.copy_(st["h"])
                    conv.copy_(st["conv"])
                    return out
            h = self._block(p, h, mix, mem_kv=mem_kv, tp=tp, where=where)
        return self._logits(params, emb, h, tp, vocab)[:, 0], cache

    # ------------------------------------------------------ serve on a mesh
    def serve_layout(self, tp: Optional[TensorParallel], batch_size: int,
                     cache_len: int):
        """(spec of each cache stack, the K/V blocks' ``KVLayout`` or
        None, whether the model axis splits the cross K/V's heads) of a
        cache of ``batch_size`` rows (this rank's) and ``cache_len``
        positions on ``tp``'s mesh: ``tree_specs`` of ``cache_axes``
        under ``tp.rules``, the batch over ``tp.batch_axes``.  Without a
        mesh (``tp`` None) the cache is whole: (None, None, False)."""
        if tp is None:
            return None, None, False
        mesh = tp.mesh
        B = batch_size * mesh.axis_size(tp.batch_axes)
        shapes, axes = self.cache_axes(B, cache_len)
        rules = dict(tp.rules, batch=tp.batch_axes)
        specs = tree_specs(shapes, axes, mesh, rules)
        for name, spec in specs.items():
            got = entry_axes(spec[1]) if len(spec) > 1 else ()
            if mesh.axis_size(got) != mesh.axis_size(tp.batch_axes):
                raise ValueError(f"{self.cfg.name}: a batch of {B} rows "
                                 f"does not split over {tp.batch_axes} in "
                                 f"the cache's {name!r} ({spec})")
        layout = None
        if "k" in specs:
            spec = specs["k"] + (None,) * 5
            if spec[3] is not None and spec[2] is not None:
                raise ValueError(f"K/V cache spec {specs['k']}: positions "
                                 f"and heads both split")
            layout = KVLayout(mesh, entry_axes(spec[2]),
                              spec[3] is not None, cache_len)
        cross = "cross_k" in specs and len(specs["cross_k"]) > 3 and \
            specs["cross_k"][3] is not None
        return specs, layout, cross

    def cache_axes(self, batch_size: int, cache_len: int):
        """(``cache_specs``' cache as meta tensors, its axes tree): each
        stack's logical axes as the reference's ``cache_specs`` tags its
        leaves, behind the stack's leading ``"layers"`` (never split)::

            k, v                ("layers", "batch", "kv_seq", "kv_heads",
                                 "head_dim")
            cross_k, cross_v    ("layers", "batch", "enc_seq", "kv_heads",
                                 "head_dim")
            ssd_h               ("layers", "batch", "ssm_heads", "head_dim",
                                 "state")
            ssd_conv            ("layers", "batch", "conv", "conv_ch")
            rglru_h             ("layers", "batch", "lru")
            rglru_conv          ("layers", "batch", "conv", "lru")
        """
        shapes = self.cache_specs(batch_size, cache_len, device="meta")
        names = {"k": ("kv_seq", "kv_heads", "head_dim"),
                 "v": ("kv_seq", "kv_heads", "head_dim"),
                 "cross_k": ("enc_seq", "kv_heads", "head_dim"),
                 "cross_v": ("enc_seq", "kv_heads", "head_dim"),
                 "ssd_h": ("ssm_heads", "head_dim", "state"),
                 "ssd_conv": ("conv", "conv_ch"),
                 "rglru_h": ("lru",),
                 "rglru_conv": ("conv", "lru")}
        return shapes, {k: ("layers", "batch") + names[k] for k in shapes}

    def _zero_cache(self, specs, tp, batch_size, cache_len, memory, dtype,
                    device) -> dict:
        """Zeroed K/V stacks of ``cache_len`` positions and, beside an
        encoder's ``memory``, cross stacks of its frames, for
        ``batch_size`` rows: this rank's blocks of them under ``tp``
        (``specs``: ``serve_layout``'s), the whole of them without."""
        B = batch_size if tp is None else \
            batch_size * tp.mesh.axis_size(tp.batch_axes)
        whole = self._kv_stacks(B, cache_len, dtype, "meta")
        if memory is not None:
            whole.update(self._cross_stacks(B, memory.shape[1], dtype,
                                            "meta"))
        return {k: torch.zeros(t.shape if tp is None else
                               block_shape(t.shape, specs[k], tp.mesh),
                               dtype=dtype, device=device)
                for k, t in whole.items()}

    def _logits(self, params, emb, h, tp, vocab):
        """The final norm and the logits (B,V) f32; under a vocabulary
        ``Split`` this rank's slice of them, all-gathered whole over the
        model axis."""
        logits = unembed(self.cfg, emb, self._final(params, h, tp))
        if vocab is None:
            return logits
        return all_gather_dim(logits, tp.mesh, vocab.axis, logits.ndim - 1)

    def _cross_read(self, p, mem_kv, split, cross_split):
        """The cross attention's K/V as this rank's query heads read them,
        from the cached (or just projected) K/V of every head, or of this
        rank's heads where the model axis splits them."""
        if split is None or cross_split:
            return mem_kv
        take = kv_heads_read(self.cfg, split, p["cross"]["wq"].shape[1],
                             mem_kv[0].device)
        return take(mem_kv[0], 2), take(mem_kv[1], 2)

    @property
    def supports_chunked_prefill(self) -> bool:
        """True when every layer is an attention block (those continue a
        prefill at an offset; the recurrent ones carry no resumable
        prefill state) and the model is neither an encoder-decoder nor a
        prefix-LM, whose cross attention and prefix mask are
        whole-prompt constructs, as in the reference."""
        return (not self.is_encdec and not self.cfg.prefix_lm
                and all(kind in ATTN_KINDS for kind in self.kinds))

    # ------------------------------------------------------------------ specs
    def cache_specs(self, batch_size: int, cache_len: int, *,
                    dtype=torch.bfloat16, device="cuda") -> dict:
        """Zeroed cache: one stack per kind of state (see the module
        docstring); recurrent ``h`` in f32, the rest in ``dtype``."""
        cfg = self.cfg
        dev = resolve_device(device)
        out = self._kv_stacks(batch_size, cache_len, dtype, dev)
        if self.is_encdec:
            out.update(self._cross_stacks(batch_size, cfg.frontend_seq,
                                          dtype, dev))
        for g, n in self.stack_sizes.items():
            if g == "attn":
                continue
            spec = _RECURRENT[g].cache_spec(cfg, batch_size, dtype,
                                            device=dev)
            for name, t in spec.items():
                out[f"{g}_{name}"] = torch.zeros((n,) + tuple(t.shape),
                                                 dtype=t.dtype, device=dev)
        return out

    def _kv_stacks(self, batch_size: int, cache_len: int, dtype,
                   device) -> dict:
        """Zeroed ``"k"``/``"v"`` stacks over the attention layers
        (``{}`` for a model without any)."""
        n = self.stack_sizes.get("attn")
        if n is None:
            return {}
        shape = (n, batch_size, cache_len, self.cfg.n_kv_heads, self.cfg.hd)
        return {name: torch.zeros(shape, dtype=dtype, device=device)
                for name in ("k", "v")}

    def _cross_stacks(self, batch_size: int, n_frames: int, dtype,
                      device) -> dict:
        """Zeroed ``"cross_k"``/``"cross_v"`` stacks over the decoder
        layers of an encoder-decoder."""
        shape = (self.cfg.n_layers, batch_size, n_frames,
                 self.cfg.n_kv_heads, self.cfg.hd)
        return {name: torch.zeros(shape, dtype=dtype, device=device)
                for name in ("cross_k", "cross_v")}
