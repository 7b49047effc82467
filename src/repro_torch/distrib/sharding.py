"""Logical-axis → mesh-axis sharding resolver, ported from
``src/repro/distrib/sharding.py`` without JAX.

Model code names every parameter dimension with a *logical* axis
(``Model.param_axes``).  This module maps those names onto mesh axes
through an ordered rule table, with the reference's fallback: a rule
applies only if its mesh axes exist, are not already used by another
dimension of the same tensor, and divide the dimension; otherwise ever
shorter prefixes of the rule are tried, down to replication.

Default layout = ZeRO-3 FSDP (+TP), as the reference's:

* tensor-parallel dims (vocab, heads, mlp, experts, …) → ``model``
* the ``embed`` dim of every weight → ``("pod", "data")`` (FSDP)
* decode KV caches: batch → ``("pod", "data")``, sequence → ``model``

A *spec* is a tuple with one entry a dimension: ``None`` (whole), an
axis name, or a tuple of axis names (the dimension split over their
product, the first axis slowest).  Trailing ``None`` entries are
dropped, as ``PartitionSpec`` drops them.  A *mesh* for resolution is
anything with a ``shape`` mapping of axis name to size (a live
``launch.mesh.Mesh``), or such a mapping itself (``abstract_mesh``).

Trees are the port's: nested dicts, lists and tuples whose leaves are
tensors (meta tensors stand in for shapes); an axes tree has the same
containers and a tuple of names at each leaf.  ``local_block`` and
``gather_block`` act on one tensor: this rank's block of a whole tensor,
and the inverse, over the named mesh axes only; ``reduce_scatter_block``
sums every rank's whole tensor and keeps this rank's block.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Rules = Dict[str, Tuple[str, ...]]
Spec = Tuple


def abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]
                  ) -> Dict[str, int]:
    """A device-less mesh for spec resolution: axis name → size."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return dict(zip(axes, (int(n) for n in shape)))


# rule values are *ordered preferences*; () / missing = replicate
DEFAULT_RULES: Rules = {
    # ---- weights: TP dims
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "inner": ("model",),
    "lru": ("model",),
    "ssm_heads": ("model",),
    # ---- weights: FSDP dim
    "embed": ("pod", "data"),
    # ---- replicated / small
    "layers": (),
    "head_dim": (),
    "state": (),
    "state_proj": (),
    "conv": (),
    "conv_ch": (),
    "frontend": (),
    "experts_unsharded": (),
    # ---- activations & caches
    "batch": ("pod", "data"),
    "kv_seq": ("model",),
    "enc_seq": (),
}


def merge_rules(base: Rules, override: Optional[Rules]) -> Rules:
    out = dict(base)
    if override:
        out.update(override)
    return out


def mesh_shape(mesh) -> Mapping[str, int]:
    """The axis name → size mapping of a live or abstract mesh."""
    shape = getattr(mesh, "shape", mesh)
    if not isinstance(shape, Mapping):
        raise TypeError(f"not a mesh: {mesh!r}")
    return shape


def spec_for(shape: Tuple[int, ...], axes: Tuple[str, ...], mesh,
             rules: Rules) -> Spec:
    """Resolve one tensor's spec."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {axes} differ in "
                         f"length")
    sizes = mesh_shape(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        pref = tuple(a for a in rules.get(name, ())
                     if a in sizes and a not in used)
        # longest prefix whose product divides the dim
        chosen = None
        for k in range(len(pref), 0, -1):
            cand = pref[:k]
            prod = math.prod(sizes[a] for a in cand)
            if prod > 1 and dim % prod == 0:
                chosen = cand
                break
        if chosen:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, slowest first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` and the nodes of ``rest``
    at the same places (an axes tree's tuples are taken whole)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_specs(shape_tree, axes_tree, mesh, rules: Optional[Rules] = None):
    """(tensor tree, axes tree) → spec tree; ``rules`` override
    ``DEFAULT_RULES``."""
    rules = merge_rules(DEFAULT_RULES, rules)
    return _map(lambda t, axes: spec_for(tuple(t.shape), tuple(axes), mesh,
                                         rules), shape_tree, axes_tree)


def block_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` under
    ``spec`` (each split dimension divided by its axes' product)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= math.prod(sizes[a] for a in entry_axes(entry))
    return tuple(out)


class Sharding(NamedTuple):
    """A leaf's spec on a live mesh (the reference's ``NamedSharding``)."""
    mesh: object
    spec: Spec


def tree_shardings(shape_tree, axes_tree, mesh,
                   rules: Optional[Rules] = None):
    specs = tree_specs(shape_tree, axes_tree, mesh, rules)
    return _map(lambda t, spec: Sharding(mesh, spec), shape_tree, specs)


def bytes_per_device(shape_tree, axes_tree, mesh,
                     rules: Optional[Rules] = None) -> int:
    """Analytic bytes a device of a sharded tree, as the reference's."""
    specs = tree_specs(shape_tree, axes_tree, mesh, rules)
    sizes = mesh_shape(mesh)
    total = 0

    def add(t, spec):
        nonlocal total
        div = math.prod(sizes[a] for e in spec for a in entry_axes(e))
        total += t.numel() * t.element_size() // max(div, 1)

    _map(add, shape_tree, specs)
    return total


# ---------------------------------------------------------------------------
# one rank's block, and back
# ---------------------------------------------------------------------------
def _dim_blocks(spec: Spec, mesh, axes):
    """Per dimension of ``spec``: (number of blocks, this rank's block) over
    the entry's axes that lie in ``axes`` (None: all).  Those must end the
    entry, so the blocks they index are contiguous."""
    out = []
    for entry in spec:
        names = entry_axes(entry)
        take = tuple(a for a in names if axes is None or a in axes)
        if take != names[len(names) - len(take):]:
            raise ValueError(f"axes {axes} cut the entry {entry} of spec "
                             f"{spec} in the middle")
        out.append((mesh.axis_size(take), mesh.axis_index(take)))
    return out


def local_block(x: torch.Tensor, spec: Spec, mesh, axes=None
                ) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` on the live ``mesh``, over
    the mesh axes ``axes`` only (default all); a copy, so the whole
    tensor can be freed."""
    for d, (n, idx) in enumerate(_dim_blocks(spec, mesh, axes)):
        if n > 1:
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split into {n} blocks")
            b = x.shape[d] // n
            x = x.narrow(d, idx * b, b)
    return x.contiguous().clone()


def gather_block(x_local: torch.Tensor, spec: Spec, mesh, axes=None,
                 keep_dtype: bool = False) -> torch.Tensor:
    """The inverse of ``local_block``: the blocks of every rank that
    differs from this one only on the mesh axes ``axes`` (default all),
    put together.  Each dimension split over some of those axes takes
    one ``collectives.all_gather_dim``, in the form
    ``collectives.collective_form`` picks (an all-gather; for gloo with
    CUDA tensors an all-reduce of a zero buffer holding this rank's
    block).  Where no such axis splits the tensor, ``x_local`` itself.
    ``keep_dtype``: as ``collectives.all_gather_dim``'s."""
    from .collectives import all_gather_dim
    _dim_blocks(spec, mesh, axes)
    x = x_local
    for d, entry in enumerate(spec):
        take = tuple(a for a in entry_axes(entry)
                     if axes is None or a in axes)
        if take:
            x = all_gather_dim(x, mesh, take, d, keep_dtype)
    return x


def reduce_scatter_block(x: torch.Tensor, spec: Spec, mesh, axes,
                         keep_dtype: bool = False) -> torch.Tensor:
    """The sum of ``x`` (each rank's tensor whole over the mesh axes
    ``axes``, as ``gather_block`` gives it) over the ranks of ``axes``,
    and this rank's block of the sum (``local_block``'s): one
    ``collectives.reduce_scatter_dim`` for each dimension split over some
    of ``axes``, then an all-reduce over the axes that split none.
    ``x`` itself where ``axes`` is empty.  ``keep_dtype``: every call
    sums in ``x``'s dtype (``collectives.all_reduce``'s)."""
    from .collectives import all_reduce, reduce_scatter_dim
    _dim_blocks(spec, mesh, axes)
    done = set()
    for d, entry in enumerate(spec):
        take = tuple(a for a in entry_axes(entry) if a in axes)
        if take:
            x = reduce_scatter_dim(x, mesh, take, d, keep_dtype)
            done.update(take)
    rest = tuple(a for a in axes if a not in done)
    return all_reduce(x, mesh, rest, keep_dtype=keep_dtype) if rest else x
