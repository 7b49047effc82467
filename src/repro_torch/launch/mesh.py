"""Device meshes over ``torch.distributed``, ported from
``src/repro/launch/mesh.py``.

A ``Mesh`` lays the ranks of the initialised world out on named axes in
row-major order (rank = Σ coordinate · stride, the last axis fastest, as
``jax.make_mesh`` orders its devices) and holds one process group for
each subset of its axes: the ranks that share this rank's coordinates on
every other axis.  A collective over axes ``("data",)`` runs in the group
of this rank's column; over ``("data", "model")`` in the whole world.
Every rank creates every group, in one order, when the mesh is built:
``torch.distributed.new_group`` must be called by all ranks alike.

The backend is the caller's choice and nothing switches it on failure:

* ``"nccl"``: one rank a card.  Two ranks on one device are refused
  before any communicator is made (NCCL cannot hold them).
* ``"gloo"``: ranks that share a card or run on the CPU.  Gloo takes CUDA
  tensors for ``all_reduce`` and ``broadcast`` (staging them through the
  host), which is all the port's collectives use.
* ``"fake"``: the dry run's world (``launch/dryrun.py``), one process
  standing for one rank of 256 or 512 whose collectives move nothing;
  taken only where the world itself was initialised with that backend.

The caller initialises the world (``init_process_group`` with its own
address, world size and rank) before it builds a mesh.  Groups of one
rank are made and used like any other, so a one-rank mesh runs every
collective of the code path.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl", "fake")


def _device_id(device: int) -> str:
    """A card's identity across processes (its UUID)."""
    props = torch.cuda.get_device_properties(device)
    return str(getattr(props, "uuid", props.pci_bus_id))


class Mesh:
    """Named axes over the world's ranks, with a process group for each
    subset of axes.  ``shape`` maps axis → size (the reference's
    ``mesh.shape``); ``coords`` maps axis → this rank's index on it."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                 backend: str):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        if not dist.is_initialized():
            raise RuntimeError("Mesh: torch.distributed is not initialised; "
                               "call init_process_group first")
        if (backend == "fake") != (dist.get_backend() == "fake"):
            raise ValueError(f"Mesh: backend {backend!r} in a world "
                             f"initialised with {dist.get_backend()!r}")
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes}")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} "
                             f"ranks; the world has {world}")
        self.backend = backend
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, (int(n) for n in shape)))
        self.size = world
        self.rank = dist.get_rank()
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        self._strides = dict(zip(axes, strides))
        self.coords = {a: (self.rank // s) % self.shape[a]
                       for a, s in self._strides.items()}
        if backend == "nccl":
            self._check_one_rank_a_card()
        self._groups = {}
        for k in range(1, len(axes) + 1):
            for sub in itertools.combinations(axes, k):
                self._groups[sub] = self._make_groups(sub)

    def _check_one_rank_a_card(self):
        """Raises unless every rank's current CUDA device (the one its
        NCCL communicator uses) is a card of its own."""
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("Mesh: backend 'nccl' needs CUDA and NCCL; "
                               "use 'gloo' for ranks on the CPU")
        ids = [None] * self.size
        dist.all_gather_object(ids, _device_id(torch.cuda.current_device()),
                               group=dist.new_group(backend="gloo"))
        if len(set(ids)) != len(ids):
            raise RuntimeError(f"Mesh: backend 'nccl' takes one rank a "
                               f"card; ranks share devices {ids}; use "
                               f"'gloo' for ranks that share a card")

    def _make_groups(self, sub: Tuple[str, ...]):
        """Every rank calls new_group for every coset of ``sub``, in one
        order; returns the group of this rank's coset."""
        rest = [a for a in self.axis_names if a not in sub]
        mine = None
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            base = sum(i * self._strides[a] for a, i in zip(rest, fixed))
            ranks = sorted(
                base + sum(i * self._strides[a] for a, i in zip(sub, free))
                for free in itertools.product(*(range(self.shape[a])
                                                for a in sub)))
            group = dist.new_group(ranks=ranks, backend=self.backend)
            if self.rank in ranks:
                mine = group
        return mine

    def group(self, axes) -> Optional[object]:
        """The process group of this rank over ``axes`` (names, in any
        order)."""
        if isinstance(axes, str):
            axes = (axes,)
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(set(axes)):
            raise ValueError(f"axes {axes} not all in mesh "
                             f"{self.axis_names}")
        return self._groups[key]

    def axis_size(self, axes) -> int:
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape[a] for a in axes)

    def axis_index(self, axes) -> int:
        """This rank's index over ``axes`` (the first slowest)."""
        if isinstance(axes, str):
            axes = (axes,)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def span(self, axes) -> int:
        """How many consecutive ranks this rank's group over ``axes``
        spans, from its lowest rank to its highest."""
        if isinstance(axes, str):
            axes = (axes,)
        return 1 + sum((self.shape[a] - 1) * self._strides[a] for a in axes)

    def __repr__(self):
        return (f"Mesh({self.shape}, backend={self.backend!r}, "
                f"rank={self.rank}, coords={self.coords})")


def make_production_mesh(multi_pod: bool = False, *, backend: str) -> Mesh:
    """The assignment mesh: (16, 16) = (data, model), or (2, 16, 16) =
    (pod, data, model) over two pods; raises unless the world has that
    many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, backend=backend)


def make_local_mesh(model_axis: int = 1, *, backend: str) -> Mesh:
    """(data, model) over the initialised world: ``model_axis`` ranks a
    model row, the rest of the world along ``data``."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world == 0:
        raise RuntimeError("make_local_mesh: torch.distributed is not "
                           "initialised; call init_process_group first")
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the "
                         f"world of {world} ranks")
    return Mesh((world // model_axis, model_axis), ("data", "model"),
                backend=backend)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present on a mesh, in (pod, data) order."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


# NVIDIA H100 SXM5 80GB, data-sheet figures (the dry run's roofline
# denominators and the kernels' bounds, ``kernels/cost.py``; the
# counterpart of the reference's TPU v5e table)
HW = {
    "peak_flops_bf16": 989e12,      # dense bf16 tensor cores, per card
    "hbm_bw": 3.35e12,              # bytes/s per card
    "hbm_bytes": 80e9,              # 80 GB per card
    "nvlink_bw": 450e9,             # bytes/s each way, a card within a node
    "node_size": 8,                 # cards a node, joined by NVLink
    "nic_bw": 50e9,                 # one 400 Gb/s NIC a card across nodes
}
