"""Model / parallelism / shape configuration.

One :class:`ModelConfig` covers every assigned architecture family
(dense, MoE, SSM, hybrid, enc-dec, VLM/audio-stub).  The per-layer block
pattern is expressed as a *period*: a short tuple of block kinds that
repeats down the stack (``("attn",)`` for uniform transformers,
``("local", "local", "local", "local", "local", "global")`` for gemma3's
5:1 mix, ``("rglru", "rglru", "local")`` for recurrentgemma, ``("ssd",)``
for mamba2).  Layers are stacked with ``lax.scan`` over periods so compile
time stays flat in depth; a partial trailing period is unrolled.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Block kinds understood by models/transformer.py
ATTN_KINDS = ("attn", "local", "global")
RECURRENT_KINDS = ("rglru", "ssd")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts (0 = dense MLP)
    top_k: int = 0
    num_shared_experts: int = 0     # DeepSeekMoE shared experts
    capacity_factor: float = 1.25   # train-time capacity
    router_z_coef: float = 1e-3     # router z-loss
    aux_coef: float = 1e-2          # load-balance loss
    first_layer_dense: bool = False # DeepSeekMoE: layer 0 is a dense FFN
    first_dense_ff: int = 0         # ... with its own width
    dispatch: str = "sort"          # sort | cumsum (see models/moe.py)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128            # N (SSD state size)
    head_dim: int = 64              # P (channels per SSD head)
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    ngroups: int = 1
    chunk: int = 256                # SSD chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4
    block_kind_period: int = 3      # (rec, rec, local)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab: int = 256
    # block structure
    period: Tuple[str, ...] = ("attn",)
    window: int = 1024              # sliding window for "local" blocks
    # attention details
    qkv_bias: bool = False
    attn_softcap: float = 0.0       # tanh logit soft-capping (0 = off)
    qk_norm: bool = False           # gemma3-style RMS-norm on q and k
    parallel_block: bool = False    # command-r: attn and ffn in parallel
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # separate base for "global" blocks (0 = same)
    prefix_lm: bool = False         # paligemma: bidirectional prefix
    logit_softcap: float = 0.0      # final-logit soft-capping
    # mlp
    mlp: str = "swiglu"             # swiglu | geglu | relu2 | gelu
    tie_embeddings: bool = False
    embed_scale: bool = False       # gemma-style sqrt(d_model) embed scaling
    # families
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rglru: RGLRUConfig = field(default_factory=RGLRUConfig)
    # enc-dec
    n_enc_layers: int = 0           # encdec: encoder depth (n_layers = decoder)
    # modality frontends (stub: precomputed embeddings arrive as inputs)
    frontend: str = "none"          # none | audio_frames | vision_patches
    frontend_seq: int = 0           # frames/patches per example
    frontend_dim: int = 0           # raw embedding dim before projection
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def trailing(self) -> Tuple[str, ...]:
        return self.period[: self.n_layers % len(self.period)]

    @property
    def is_recurrent_family(self) -> bool:
        return any(k in RECURRENT_KINDS for k in self.period)

    @property
    def supports_long_context(self) -> bool:
        """long_500k applies unless the arch is *pure* full attention.

        Skip rule (assignment): pure full-attention archs skip long_500k.
        A uniform ``attn`` stack is pure; SSM/hybrid and mixes dominated by
        bounded-window blocks (gemma3's 5:1 local:global, recurrentgemma's
        rglru+local) qualify — their decode state is O(window)/O(1) on all
        or most layers.
        """
        return "attn" not in self.period

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND."""
        c = self
        hd = self.hd
        n = c.vocab * c.d_model  # embedding (+ untied head counted below)
        if not c.tie_embeddings:
            n += c.vocab * c.d_model
        per_kind = {}
        attn = c.d_model * (c.n_heads * hd) + 2 * c.d_model * (c.n_kv_heads * hd) \
            + (c.n_heads * hd) * c.d_model
        mlp_mult = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[c.mlp]
        dense_mlp = mlp_mult * c.d_model * c.d_ff
        moe_mlp = dense_mlp * (c.moe.num_experts + c.moe.num_shared_experts) \
            + c.d_model * c.moe.num_experts
        for kind in set(c.period) | set(c.trailing):
            if kind in ATTN_KINDS:
                body = attn + (moe_mlp if c.moe.num_experts else dense_mlp)
            elif kind == "rglru":
                w = c.rglru.lru_width or c.d_model
                body = 2 * c.d_model * w + w * c.d_model + 3 * w \
                    + c.rglru.conv_width * w + dense_mlp
            elif kind == "ssd":
                s = c.ssm
                d_in = s.expand * c.d_model
                nheads = d_in // s.head_dim
                zxbcdt = c.d_model * (2 * d_in + 2 * s.ngroups * s.state_dim + nheads)
                body = zxbcdt + s.conv_width * (d_in + 2 * s.ngroups * s.state_dim) \
                    + d_in * c.d_model + 2 * nheads
            else:
                raise ValueError(kind)
            per_kind[kind] = body
        for i in range(c.n_layers):
            kind = (list(c.period) * ((i // len(c.period)) + 1) + list(c.trailing))[i] \
                if False else c.kind_at(i)
            n += per_kind[kind]
        if c.moe.first_layer_dense and c.moe.num_experts:
            # layer 0 swaps MoE for a dense FFN of first_dense_ff
            n -= moe_mlp
            n += mlp_mult * c.d_model * c.moe.first_dense_ff
        if c.n_enc_layers:
            # encoder self-attn + mlp, decoder adds cross-attn
            n += c.n_enc_layers * (attn + dense_mlp)
            n += c.n_layers * attn  # cross-attention in each decoder layer
        if c.frontend != "none" and c.frontend_dim:
            n += c.frontend_dim * c.d_model
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        c = self
        if not c.moe.num_experts:
            return self.param_count()
        mlp_mult = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[c.mlp]
        dense_mlp = mlp_mult * c.d_model * c.d_ff
        inactive_per_moe_layer = dense_mlp * (
            c.moe.num_experts - c.moe.top_k)
        n_moe_layers = c.n_layers - (1 if c.moe.first_layer_dense else 0)
        return self.param_count() - n_moe_layers * inactive_per_moe_layer

    def kind_at(self, i: int) -> str:
        return self.period[i % len(self.period)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How a step is laid out on the mesh (see distrib/sharding.py)."""

    fsdp: bool = True               # shard params+opt over the data axis
    fsdp_axis: str = "data"
    tensor_axis: str = "model"
    pod_axis: Optional[str] = None  # present on the multi-pod mesh
    pipeline_stages: int = 1        # >1 enables the PP stage runner
    microbatches: int = 1           # grad-accumulation steps
    remat: str = "block"            # none | block | full
    seq_shard_decode: bool = True   # shard KV cache sequence over `model`
    compress_grads: bool = False    # int8 all-reduce w/ error feedback
    decode_twopass: bool = True     # shard_map 2-pass decode softmax
    param_gather_dtype: str = ""    # "bfloat16": cast params before use so
                                    # FSDP all-gathers / grad reduces travel
                                    # in 16-bit (mixed-precision ZeRO-3)

    def replace(self, **kw) -> "ParallelConfig":
        return dataclasses.replace(self, **kw)
