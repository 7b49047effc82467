"""How the sharded training step lays a model out on a mesh: which mesh
axes each stored leaf is gathered over, where, and which sub-layers
compute in tensor parallel over the model axis.

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
heads, an MLP on its slice of ``mlp``, the embedding and the loss on its
slice of the vocabulary.  Its input enters through ``Split.enter``
(``CopyToAxes``: identity forward, the partial gradients summed over
the model axis backward) and its partial output leaves through
``Split.leave`` (``ReduceFromAxes``: the sum forward, identity
backward), Megatron's f and g.  A leaf whole on every rank of the model
axis that such a sub-layer reads (replicated K/V heads, the qk norms)
enters the same way, so its partial gradients are summed there.

A recurrent block (``rec``: SSD, RG-LRU) runs whole on every rank of the
model axis: its leaves are gathered over the model axis too, whose
backward keeps this rank's block of the gradient without a sum (every
rank computed the same one).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Optional, Tuple

from .collectives import CopyToAxes, GatherFromAxes, ReduceFromAxes
from .sharding import entry_axes, tree_specs

# the part-tree keys that are containers, not sub-layers
_CONTAINERS = ("layers", "encoder")


@dataclass(frozen=True)
class Split:
    """A sub-layer split along the mesh axis ``axis``: this rank holds
    share ``rank`` of ``n``."""
    mesh: object
    axis: str

    @property
    def n(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def rank(self) -> int:
        return self.mesh.coords[self.axis]

    def enter(self, x):
        """A tensor whole on every rank that the rank's share reads (the
        sub-layer's input, or a whole leaf): its partial gradients are
        summed (f)."""
        return CopyToAxes.apply(x, self.mesh, self.axis)

    def leave(self, x):
        """The sum of the ranks' partial outputs (g)."""
        return ReduceFromAxes.apply(x, self.mesh, self.axis)


def sublayer(path) -> str:
    """The sub-layer a leaf path names: ``("layers", 3, "attn", "wq")``
    → ``"attn"``, ``("embed", "embedding")`` → ``"embed"``."""
    return next(k for k in path
                if isinstance(k, str) and k not in _CONTAINERS)


class TensorParallel:
    """The layout of ``model`` on ``mesh``: tokens split over
    ``data_axes``, the tensor-parallel dims over ``model_axis`` (None:
    no such axis), ``moe`` the MoE layers' view (``models.moe.MoESpmd``,
    or None).  ``gathers`` counts the leaves gathered by (sub-layer, mesh
    axes)."""

    def __init__(self, model, mesh, data_axes: Tuple[str, ...],
                 model_axis: Optional[str], moe=None):
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.model_axis = model_axis if model_axis in mesh.shape else None
        self.moe = moe
        self.specs = tree_specs(model.init(device="meta"),
                                model.param_axes(), mesh)
        self.gathers: Counter = Counter()
        self._splits = {}

    def spec_at(self, path):
        spec = self.specs
        for key in path:
            spec = spec[key]
        return spec

    def gather(self, part, path):
        """The part of the stored tree at ``path`` (a dict, list or leaf
        of blocks), each leaf gathered for compute: over the data axes,
        and a recurrent block's over the model axis too."""
        return self._gather(part, self.spec_at(path), tuple(path))

    def _gather(self, part, spec, path):
        if isinstance(part, dict):
            return {k: self._gather(v, spec[k], path + (k,))
                    for k, v in part.items()}
        if isinstance(part, (list, tuple)):
            return type(part)(self._gather(v, spec[i], path + (i,))
                              for i, v in enumerate(part))
        same = ((self.model_axis,) if self.model_axis and "rec" in path
                else ())
        out = GatherFromAxes.apply(part, spec, self.mesh, self.data_axes,
                                   same)
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
            self._splits[path] = (Split(self.mesh, self.model_axis)
                                  if self.model_axis in found else None)
        return self._splits[path]
