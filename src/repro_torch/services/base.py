"""Service substrate of the port: tree <-> named-buffer codecs, Fletcher-64
checksums and manifests shared by the checkpoint and datafeed services,
and the replicated-call straggler helper.  Ported from
``src/repro/services/base.py`` (``AdmissionController`` lives in
``admission.py``).

Names are the strings ``jax.tree_util.keystr`` gives for the same nested
dict / list / tuple (dict keys in sorted order, ``['layers'][0]['attn']
['wq']``), so a manifest written by either package names the same
leaves.  A leaf is a torch tensor, on any device, or anything numpy
takes.  Checksums run where the leaf lies: the Fletcher-64 kernel for
tensors on the card (all of a tree's in one batch), its plain version
for a CPU tensor or a numpy array.

Manifests carry numpy's dtype names; ``"bfloat16"`` shards (numpy has no
bf16 of its own, and the port does not use ``ml_dtypes``) travel as raw
uint16 host buffers with the same bytes.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.executor import Engine
from ..core.types import MercuryError, Ret
from ..kernels.fletcher import fletcher64_many

# numpy's name for a dtype whose host buffer numpy cannot hold itself,
# and the same-width type that holds its bytes
_RAW_HOST = {"bfloat16": np.uint16}


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr, leaf) in ``jax.tree_util`` flattening order; None is an
    empty subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}[{i}]")
    elif tree is not None:
        yield prefix, tree


def _rebuild(template, leaves: Dict[str, Any], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves, f"{prefix}[{k!r}]")
                for k in template}
    if isinstance(template, (list, tuple)):
        out = [_rebuild(v, leaves, f"{prefix}[{i}]")
               for i, v in enumerate(template)]
        return type(template)(out) if isinstance(template, tuple) else out
    return None if template is None else leaves[prefix]


def dtype_name(x) -> str:
    """numpy's name for the leaf's dtype ("float32", "bfloat16", ...)."""
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def flatten_named(tree) -> Dict[str, Any]:
    """Tree → {keystr: leaf}; tensors stay where they are, other leaves
    become numpy arrays."""
    return {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in _items(tree)}


def _cast_like(arr, want):
    """``arr`` in the dtype of the template leaf ``want``: a numpy array
    stays numpy, a tensor stays on its device."""
    if isinstance(arr, np.ndarray):
        return arr.astype(np.asarray(want).dtype, copy=False)
    if isinstance(want, torch.Tensor):
        return arr.to(want.dtype)
    return arr.to(torch.from_numpy(np.empty(0, np.asarray(want).dtype)).dtype)


def unflatten_named(template, named: Dict[str, Any]):
    """Rebuild a tree shaped like ``template`` from {keystr: leaf}, each
    leaf in its template leaf's dtype."""
    leaves = {}
    for key, want in _items(template):
        if key not in named:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = named[key]
        if tuple(arr.shape) != tuple(np.shape(want)):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                             f"{tuple(np.shape(want))}")
        leaves[key] = _cast_like(arr, want)
    return _rebuild(template, leaves)


def host_copy(x) -> np.ndarray:
    """A contiguous host buffer with the leaf's bytes: a copy of a card
    tensor, a view of a CPU tensor; bf16 as uint16."""
    if not isinstance(x, torch.Tensor):
        return np.ascontiguousarray(x)
    t = x.detach().contiguous().cpu()
    if dtype_name(t) in _RAW_HOST:
        return t.view(torch.int16).numpy().view(_RAW_HOST[dtype_name(t)])
    return t.numpy()


def host_to_tensor(buf: np.ndarray, name: str, device) -> torch.Tensor:
    """A host buffer of manifest dtype ``name`` as a tensor on
    ``device``."""
    if name in _RAW_HOST:
        return torch.from_numpy(buf.view(np.int16)).view(
            getattr(torch, name)).to(device)
    return torch.from_numpy(buf).to(device)


def checksum_of(x) -> int:
    """Fletcher-64 over the leaf's raw bytes (padded to a u32 boundary),
    on the leaf's device."""
    return fletcher64_many([x])[0]


def manifest_of(named: Dict[str, Any]) -> dict:
    return {
        "keys": list(named.keys()),
        "shapes": [list(v.shape) for v in named.values()],
        "dtypes": [dtype_name(v) for v in named.values()],
        "nbytes": [int(v.numel() * v.element_size())
                   if isinstance(v, torch.Tensor) else int(v.nbytes)
                   for v in named.values()],
        # hex (Fletcher-64 exceeds the signed-i64 wire int)
        # the card's leaves in one batch
        "checksums": [f"{c:016x}"
                      for c in fletcher64_many(list(named.values()))],
    }


def alloc_from_manifest(man: dict) -> Dict[str, np.ndarray]:
    """Host buffers for the manifest's shards (bf16 as uint16)."""
    return {k: np.empty(tuple(s), dtype=_RAW_HOST[d] if d in _RAW_HOST
                        else np.dtype(d))
            for k, s, d in zip(man["keys"], man["shapes"], man["dtypes"])}


def verify_manifest(man: dict, named: Dict[str, Any]) -> None:
    """Raise ``CHECKSUM_ERROR`` for the first shard whose bytes do not
    match; the checksums run on the shards' devices, in one batch."""
    got = fletcher64_many([named[k] for k in man["keys"]])
    for k, g, want in zip(man["keys"], got, man["checksums"]):
        if f"{g:016x}" != want:
            raise MercuryError(Ret.CHECKSUM_ERROR,
                               f"shard {k}: {g:016x} != {want}")


# ---------------------------------------------------------------------------
# straggler mitigation: replicated issue, first-wins
# ---------------------------------------------------------------------------
def replicated_call(engine: Engine, targets: Sequence[str], name: str,
                    arg: Any = None, timeout: float = 30.0) -> Any:
    """Issue the same RPC to every target; first success wins, the rest
    are abandoned (their handles are canceled at transport level when the
    engine GC's them).  Raises the last error if all fail."""
    if not targets:
        raise MercuryError(Ret.INVALID_ARG, "no targets")
    futs = [engine.call_async(t, name, arg, timeout=timeout)
            for t in targets]
    last_err: Optional[Exception] = None
    done_any = threading.Event()
    result_box: dict = {}

    def watch(f):
        nonlocal last_err
        try:
            r = f.result()
            if not done_any.is_set():
                result_box["v"] = r
                done_any.set()
        except Exception as e:
            last_err = e
            if all(fu.done() for fu in futs) and not done_any.is_set():
                done_any.set()

    for f in futs:
        f.add_done_callback(watch)
    done_any.wait(timeout + 5.0)
    if "v" in result_box:
        return result_box["v"]
    raise last_err or MercuryError(Ret.TIMEOUT, name)
