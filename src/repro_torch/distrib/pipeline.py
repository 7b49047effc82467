"""Pipeline-parallel stage runner (GPipe schedule), ported from
``src/repro/distrib/pipeline.py``.

Layers are split into ``n_stages`` contiguous stages, one a rank along
the mesh axis ``stage_axis``; microbatches stream through with the
classic (n_micro + n_stages − 1)-step schedule.  At each step stage 0
takes microbatch t, every other stage the activation its predecessor
made at step t − 1, and the last stage keeps microbatch t − (n_stages −
1) as it comes out.

The hand-off is the reference's ``ppermute`` to the next stage written
as a masked all-reduce: every rank puts its output in slot ``sid + 1``
of a zeroed (n_stages, microbatch) buffer, the buffer is summed over the
stage axis, and rank ``sid`` reads slot ``sid``.  It runs on gloo (ranks
that share a card, CUDA or CPU tensors) and NCCL alike.  At the end the
last stage's outputs go to every rank by one more masked all-reduce, as
the reference's ``psum``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .collectives import all_reduce


def pipeline_apply(stage_fn: Callable, params_local, x_micro, mesh,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_local, x) -> x`` over the stages of
    ``stage_axis``.

    params_local: this rank's stage's parameters (any structure).
    x_micro:      (n_micro, mb, ...) microbatched input, the same on
                  every rank.
    Returns (n_micro, mb, ...) outputs, the same on every rank."""
    n_stages = mesh.shape[stage_axis]
    sid = mesh.coords[stage_axis]
    last = n_stages - 1
    n_micro = x_micro.shape[0]
    carry = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        inp = x_micro[min(t, n_micro - 1)] if sid == 0 else carry
        out = stage_fn(params_local, inp)
        if sid == last and t >= last:
            outs[t - last] = out.to(outs.dtype)
        # the hand-off: stage sid's output to stage sid + 1
        hand = x_micro.new_zeros((n_stages,) + tuple(out.shape),
                                 dtype=out.dtype)
        if sid < last:
            hand[sid + 1] = out
        carry = all_reduce(hand, mesh, stage_axis)[sid]
    # every rank returns the last stage's buffer
    if sid != last:
        outs.zero_()
    return all_reduce(outs, mesh, stage_axis)
