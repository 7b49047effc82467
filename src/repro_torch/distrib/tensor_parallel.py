"""How the sharded training step lays a model out on a mesh: which mesh
axes each stored leaf is gathered over, where, which sub-layers compute
in tensor parallel over the model axis, and whether the residual stream
between them is split over the sequence.

Each rank stores its block of every leaf (``tree_specs`` under
``DEFAULT_RULES``).  ``TensorParallel.gather`` makes a part of the tree
(a layer, the embedding, a final norm) ready for compute inside the
function that uses it: each leaf is gathered over the data axes only
(``GatherFromAxes``: forward an all-gather, backward a reduce-scatter of
the gradient back to the block), so it keeps its split over the model
axis.  Under ``remat="block"`` a layer's recompute gathers again, and a
rank holds one layer's gathered leaves at a time beside its blocks.

A sub-layer whose leaves the model axis splits (``TensorParallel.split``
gives its ``Split``) computes on this rank's share: attention on its
heads, an MLP on its slice of ``mlp``, an SSD block on its heads and
its slice of ``inner``, an RG-LRU block on its ``lru`` channels, the
embedding and the loss on its slice of the vocabulary.  Its input
enters through ``Split.enter`` (``CopyToAxes``: identity forward, the
partial gradients summed over the model axis backward) and its partial
output leaves through ``Split.leave`` (``ReduceFromAxes``: the sum
forward, identity backward), Megatron's f and g.  A leaf whole on every
rank of the model axis that such a sub-layer reads (replicated K/V
heads, the qk norms, an SSD block's B/C projections and conv) enters
through ``Split.shared``, so its partial gradients are summed there.

A recurrent block (``rec``) runs whole on every rank of the model axis
only where the model axis splits none of its tensor-parallel dims
(``inner``, ``ssm_heads``, ``lru``): a model axis of one rank, or dims
it does not divide.  Its leaves are then gathered over the model axis
too, whose backward keeps this rank's block of the gradient without a
sum (every rank computed the same one).  A block the model axis splits
in part (``inner`` but not ``ssm_heads``, or the reverse) is refused
when the layout is built.

**Sequence parallelism** (``seq_parallel=True``, Korthikanti et al.):
the residual stream between the sub-layers holds this rank's ``S/n``
positions.  ``Split.enter`` then all-gathers the sub-layer's input over
the model axis along the sequence (backward a reduce-scatter) and
``Split.leave`` reduce-scatters its partial output along the sequence
(backward an all-gather): the same ``GatherFromAxes`` /
``ReduceScatterToAxes`` with the activation spec ``(None, model)``.
The norms on the stream then see a shard, so their weights enter
through ``TensorParallel.on_stream`` (their gradients summed over the
model axis); the loss runs on the hidden states put back together
(``Split.whole``).  It is refused for a config with experts, a frontend
or an encoder, and where some sub-layer runs whole; over a model axis
of one rank it changes nothing.  ``seq_parallel_for`` is the
reference's rule for choosing it (``act_sharding_for``).

**Flat data parallelism** (the dry run's ``flat_dp``): rules that
split nothing over the model axis and spread ``embed`` and the batch
over every axis, with the model axis among ``data_axes``.  No sub-layer
is then split (every ``split`` is None) and each leaf is gathered over
all the axes.

**16-bit gathers** (``param_dtype``, ``ParallelConfig.param_gather_dtype``):
each f32 stored block is cast to that dtype before its gather, as the
reference's ``cast_params`` runs before the loss; the gather and its
gradient's reduce-scatter then travel in 16 bits (``keep_dtype``), and
the cast's backward hands the f32 block its gradient.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .collectives import (CopyToAxes, GatherFromAxes, ReduceFromAxes,
                          ReduceScatterToAxes)
from .sharding import entry_axes, mesh_shape, tree_specs

# the part-tree keys that are containers, not sub-layers
_CONTAINERS = ("layers", "encoder")
# a recurrent block's logical dims that the model axis splits
_REC_DIMS = ("inner", "ssm_heads", "lru")
# the reference's width above which a dense model trains sequence-parallel
WIDE_D_MODEL = 3840


@dataclass(frozen=True)
class Split:
    """A sub-layer split along the mesh axis ``axis``: this rank holds
    share ``rank`` of ``n``.  ``seq``: the residual stream outside the
    sub-layer holds this rank's positions (sequence parallelism).
    ``inside``: the input has already entered and the caller sums the
    output (a parallel block's two halves share one entry and one
    exit), so ``enter`` and ``leave`` pass their tensor through."""
    mesh: object
    axis: str
    seq: bool = False
    inside: bool = False

    @property
    def n(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def rank(self) -> int:
        return self.mesh.coords[self.axis]

    def enter(self, x):
        """The sub-layer's input (B,S,...), made whole on every rank: its
        partial gradients summed (f); under ``seq`` the ranks' positions
        gathered along dim 1, the gradient reduce-scattered back."""
        if self.inside:
            return x
        if self.seq:
            return GatherFromAxes.apply(x, (None, self.axis), self.mesh,
                                        (self.axis,))
        return CopyToAxes.apply(x, self.mesh, self.axis)

    def leave(self, x):
        """The sum of the ranks' partial outputs (g); under ``seq`` this
        rank's positions of the sum (a reduce-scatter along dim 1)."""
        if self.inside:
            return x
        if self.seq:
            return ReduceScatterToAxes.apply(x, (None, self.axis),
                                             self.mesh, (self.axis,))
        return ReduceFromAxes.apply(x, self.mesh, self.axis)

    def shared(self, x):
        """A tensor whole on every rank of the axis that this rank's share
        reads (a whole leaf, or a sum every rank uses): identity forward,
        its partial gradients summed over the axis."""
        return CopyToAxes.apply(x, self.mesh, self.axis)

    def sum(self, x):
        """The sum of the ranks' partial ``x`` over the axis, each rank's
        gradient the sum's (identity backward)."""
        return ReduceFromAxes.apply(x, self.mesh, self.axis)

    def whole(self, x):
        """The stream's shards (B, S/n, ...) put together along dim 1 for
        a computation every rank runs the same (the loss): backward, this
        rank's positions of the gradient, without a sum."""
        return GatherFromAxes.apply(x, (None, self.axis), self.mesh, (),
                                    (self.axis,))

    def fused(self) -> "Split":
        """This split as one half of a region whose input the caller has
        entered and whose output it leaves with the other half's."""
        return dataclasses.replace(self, inside=True)


def sublayer(path) -> str:
    """The sub-layer a leaf path names: ``("layers", 3, "attn", "wq")``
    → ``"attn"``, ``("embed", "embedding")`` → ``"embed"``."""
    return next(k for k in path
                if isinstance(k, str) and k not in _CONTAINERS)


def head_groups(n_heads: int, n_groups: int, n: int, rank: int
                ) -> Tuple[int, int]:
    """(first, count) of the groups that the heads of share ``rank`` of
    ``n`` read, where ``n_heads`` heads read ``n_groups`` groups in order
    (``n_heads / n_groups`` heads a group): whole groups when a share
    holds whole groups, one group when it holds part of one; else a
    ``ValueError`` (a group cut across shares)."""
    per, local = n_heads // n_groups, n_heads // n
    if local % per == 0:
        return rank * local // per, local // per
    if per % local == 0:
        return rank * local // per, 1
    raise ValueError(f"{n_heads} heads in {n_groups} groups do not split "
                     f"into {n} shares of whole groups or of one group")


def flat_dp_rules(mesh) -> dict:
    """The reference dry run's ``flat_dp`` rules on ``mesh`` (a live or
    abstract mesh): no tensor parallelism, every tensor-parallel dim
    whole, ``embed`` and ``batch`` over every axis (the data-parallel
    axes, then the model axis)."""
    every = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh)) \
        + ("model",)
    return {**{name: () for name in ("heads", "kv_heads", "mlp", "vocab",
                                     "experts", "inner", "lru",
                                     "ssm_heads")},
            "embed": every, "batch": every}


def seq_parallel_for(cfg, mesh, global_batch: int, seq_len: int,
                     kind: str = "train") -> bool:
    """Whether the reference's rule (``act_sharding_for``) splits the
    residual stream over the sequence: a wide dense model (``d_model`` ≥
    3840, no experts) training, with the global batch divisible by the
    data-parallel ranks and the sequence by the model axis.  ``mesh``: a
    live or abstract mesh."""
    shape = mesh_shape(mesh)
    n_dp = 1
    for a in ("pod", "data"):            # the data-parallel axes
        n_dp *= shape.get(a, 1)
    if global_batch % n_dp:
        return False
    wide = cfg.d_model >= WIDE_D_MODEL and not cfg.moe.num_experts
    return bool(wide and kind == "train"
                and seq_len % shape.get("model", 1) == 0)


class TensorParallel:
    """The layout of ``model`` on ``mesh``: leaves gathered over
    ``data_axes``, the tensor-parallel dims over ``model_axis`` (None:
    no such axis, or one of ``data_axes``: flat data parallelism), ``moe``
    the MoE layers' view (``models.moe.MoESpmd``, or None), the residual
    stream split over the sequence along the model axis when
    ``seq_parallel`` (``stream``, its ``Split``; None when the stream is
    whole), ``param_dtype`` the dtype f32 blocks are cast to before
    their gathers (None: gathered as stored).  ``gathers`` counts the
    leaves gathered by (sub-layer, mesh axes).

    Serving on the mesh (``Model.prefill`` / ``decode_step`` with
    ``spmd=``) also reads ``batch_axes``, the axes that split the batch
    (default ``data_axes``; ``()`` where the batch is whole on every
    rank), and ``rules``, the resolver's overrides for this layout (a
    cell's ``{"kv_seq": ("data", "model")}``), which place the cache's
    blocks."""

    def __init__(self, model, mesh, data_axes: Tuple[str, ...],
                 model_axis: Optional[str], moe=None,
                 seq_parallel: bool = False, *, batch_axes=None,
                 rules=None, param_dtype: Optional[torch.dtype] = None):
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.batch_axes = self.data_axes if batch_axes is None \
            else tuple(batch_axes)
        self.rules = dict(rules or {})
        self.model_axis = model_axis if (model_axis in mesh.shape and
                                         model_axis not in self.data_axes) \
            else None
        self.param_dtype = param_dtype
        self.moe = moe
        self.specs = tree_specs(model.init(device="meta"),
                                model.param_axes(), mesh, self.rules)
        self.gathers: Counter = Counter()
        self._splits = {}
        n = mesh.shape[self.model_axis] if self.model_axis else 1
        self._seq = bool(seq_parallel) and n > 1
        self._check_recurrent(model)
        self.stream = None
        if seq_parallel:
            self._check_seq_parallel(model)
        if self._seq:
            self.stream = Split(mesh, self.model_axis, seq=True)

    def spec_at(self, path):
        spec = self.specs
        for key in path:
            spec = spec[key]
        return spec

    def gather(self, part, path):
        """The part of the stored tree at ``path`` (a dict, list or leaf
        of blocks), each leaf gathered for compute: over the data axes,
        and a recurrent block's that runs whole over the model axis
        too."""
        return self._gather(part, self.spec_at(path), tuple(path))

    def _gather(self, part, spec, path):
        if isinstance(part, dict):
            return {k: self._gather(v, spec[k], path + (k,))
                    for k, v in part.items()}
        if isinstance(part, (list, tuple)):
            return type(part)(self._gather(v, spec[i], path + (i,))
                              for i, v in enumerate(part))
        same = ()
        if self.model_axis and "rec" in path:
            rec = path[:path.index("rec") + 1]
            if self.split(rec) is None:
                same = (self.model_axis,)
        cast = self.param_dtype is not None and part.dtype == torch.float32
        if cast:
            part = part.to(self.param_dtype)
        out = GatherFromAxes.apply(part, spec, self.mesh, self.data_axes,
                                   same, cast)
        self.gathers[(sublayer(path), self.data_axes + same)] += 1
        return out

    def split(self, path) -> Optional[Split]:
        """The ``Split`` of the sub-layer at ``path`` when the model axis
        splits any of its leaves (it then computes in tensor parallel),
        else None."""
        path = tuple(path)
        if path not in self._splits:
            found = []

            def walk(spec):
                if isinstance(spec, dict):
                    for v in spec.values():
                        walk(v)
                elif isinstance(spec, list):
                    for v in spec:
                        walk(v)
                else:
                    found.extend(a for e in spec for a in entry_axes(e))
            walk(self.spec_at(path))
            self._splits[path] = (Split(self.mesh, self.model_axis,
                                        seq=self._seq)
                                  if self.model_axis in found else None)
        return self._splits[path]

    def on_stream(self, leaf):
        """A leaf applied to the residual stream (a norm's weight): under
        sequence parallelism each rank applies it to its positions, so
        its gradient is summed over the model axis; else ``leaf``."""
        return leaf if self.stream is None else self.stream.shared(leaf)

    def _check_recurrent(self, model):
        """Refuse a recurrent block that the model axis splits in part,
        and an SSD block whose heads it splits across groups."""
        if not self.model_axis:
            return
        axes = model.param_axes()
        for i, kind in enumerate(model.kinds):
            if "rec" not in axes["layers"][i]:
                continue
            split, whole = [], []
            spec = self.specs["layers"][i]["rec"]
            for name, names in axes["layers"][i]["rec"].items():
                for d, logical in enumerate(names):
                    if logical not in _REC_DIMS:
                        continue
                    cut = (d < len(spec[name]) and self.model_axis
                           in entry_axes(spec[name][d]))
                    (split if cut else whole).append(f"{name}[{logical}]")
            if split and whole:
                raise ValueError(
                    f"layer {i} ({kind}): the model axis "
                    f"{self.model_axis!r} splits {', '.join(split)} but "
                    f"not {', '.join(whole)}; a recurrent block runs in "
                    f"tensor parallel only when it splits all of them")
            if split and kind == "ssd":
                s = model.cfg.ssm
                n_heads = s.expand * model.cfg.d_model // s.head_dim
                head_groups(n_heads, s.ngroups,
                            self.mesh.shape[self.model_axis], 0)

    def _check_seq_parallel(self, model):
        """Refuse sequence parallelism where the reference's rule never
        chooses it, and where a sub-layer would run whole."""
        cfg = model.cfg
        why = [what for what, has in (
            ("experts", cfg.moe.num_experts),
            ("a frontend", cfg.frontend != "none"),
            ("an encoder", model.is_encdec)) if has]
        if why:
            raise ValueError(f"{cfg.name}: sequence parallelism is not "
                             f"ported for a model with {' and '.join(why)}")
        if not self._seq:
            return
        whole = [f"layers[{i}].{sub}"
                 for i, layer in enumerate(self.specs["layers"])
                 for sub in ("attn", "mlp", "rec")
                 if sub in layer and self.split(("layers", i, sub)) is None]
        if whole:
            raise ValueError(f"{cfg.name}: sequence parallelism needs every "
                             f"sub-layer split over {self.model_axis!r}; "
                             f"{', '.join(whole[:4])} would run whole")

    def check_seq_len(self, seq_len: int):
        """Refuse a sequence the stream's split does not divide."""
        if self.stream is not None and seq_len % self.stream.n:
            raise ValueError(f"sequence parallelism: {seq_len} positions do "
                             f"not split over {self.stream.n} ranks of "
                             f"{self.model_axis!r}")
