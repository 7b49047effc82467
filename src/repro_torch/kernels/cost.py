"""What each hand-written kernel's call must move and compute, and the
least time an NVIDIA H100 SXM could take for it.

One reckoning serves two readers.  ``chip_smoke.py`` prints each kernel
row's ``bound_ms`` from it: bytes over the card's memory rate, or
operations over its peak for their type, whichever is larger, with each
input counted read once and each output written once.  The dry run
(``launch/dryrun.py``) adds each kernel call's bytes and operations to
its count of a traced step: a kernel wrapper given a fake tensor
(``torch._subclasses.fake_tensor``) allocates the outputs and scratch
its launch would, adds the call's work to the active ``Tally`` and
launches nothing (``route`` picks that branch).

The peaks are NVIDIA's data-sheet figures for the SXM part at its full
700 W, dense, without sparsity.  The counts are of the function, not of
an algorithm for it: an SSD chunk's in-chunk products, or an attention
tile's masked keys, are not counted.  Where the work depends on the
data, the count is what these inputs need: the (query, key) pairs the
masks leave visible at these offsets, the kept rows of a combine.  The
dry run's fake tensors hold no data: a position it cannot read counts
as the cache's end (decode after a full prompt), and a combine counts
every assignment as kept, up to the slots.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from functools import lru_cache
from typing import Iterable, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..launch.mesh import HW

HBM_BYTES_PER_S = HW["hbm_bw"]
PEAK_OPS_PER_S = {torch.bfloat16: HW["peak_flops_bf16"],
                  torch.float32: 67e12}    # f32 outside the tensor cores
TF32_OPS_PER_S = 495e12                    # dense TF32 tensor cores


def bound_of(nbytes: float, ops: float, dtype, peak=None) -> tuple:
    """(least ms, "bytes" | "operations"): bytes over 3.35 TB/s or
    operations over ``peak`` (default the dtype's), whichever is
    larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (PEAK_OPS_PER_S[dtype] if peak is None else peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# the dry run's count
# ---------------------------------------------------------------------------
def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def route(t, name: str) -> str:
    """Which branch a kernel wrapper takes for ``t``: ``"plain"`` for a
    real CPU tensor, ``"kernel"`` for a CUDA tensor or a fake one (whose
    call allocates as the launch would and launches nothing); any other
    device raises."""
    if is_fake(t):
        return "kernel"
    if t.device.type == "cpu":
        return "plain"
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return "kernel"


class Tally:
    """The kernels' work in a traced step: bytes and operations summed
    over the calls, and the calls by kernel."""

    def __init__(self):
        self.nbytes = 0.0
        self.ops = 0.0
        self.calls: Counter = Counter()


_tally: Optional[Tally] = None


@contextlib.contextmanager
def tallying():
    """Count every kernel call's work made under it (fake tensors only)."""
    global _tally
    prev, _tally = _tally, Tally()
    try:
        yield _tally
    finally:
        _tally = prev


def add(name: str, nbytes: float, ops: float) -> None:
    """A shape path's call: its work joins the active tally, if any."""
    if _tally is not None:
        _tally.nbytes += nbytes
        _tally.ops += ops
        _tally.calls[name] += 1


# ---------------------------------------------------------------------------
# attention (B1) and its backward
# ---------------------------------------------------------------------------
def visible(S: int, T: int, offsets, causal: bool, window: int, prefix,
            device="cpu") -> torch.Tensor:
    """(B, S, T) mask of the (query, key) pairs the masks leave visible."""
    qpos = torch.tensor(offsets, device=device)[:, None, None] + \
        torch.arange(S, device=device)[None, :, None]
    kpos = torch.arange(T, device=device)[None, None, :]
    m = torch.ones(len(offsets), S, T, dtype=torch.bool, device=device)
    if causal:
        cm = kpos <= qpos
        if prefix is not None:
            cm = cm | (kpos < prefix)
        m = m & cm
    if window > 0:
        m = m & (kpos > qpos - window)
    return m


@lru_cache(maxsize=4096)
def _row_pairs(S: int, T: int, off: int, causal: bool, window: int,
               prefix) -> int:
    """``visible``'s count for one row of queries at offset ``off``,
    without a tensor: each query's keys are one interval."""
    total = 0
    for s in range(S):
        q = off + s
        hi = T
        if causal:
            hi = min(T, max(q + 1, 0))
            if prefix is not None:
                hi = max(hi, min(prefix, T))
        lo = max(0, q - window + 1) if window > 0 else 0
        total += max(hi - lo, 0)
    return total


def visible_pairs(S: int, T: int, offsets, causal: bool, window: int,
                  prefix) -> int:
    """``int(visible(...).sum())`` from the shapes alone."""
    return sum(_row_pairs(S, T, int(off), bool(causal), int(window),
                          prefix) for off in offsets)


def attention_work(B: int, S: int, T: int, Hq: int, Hkv: int, D: int,
                   elt: int, offsets, causal, window, prefix
                   ) -> Tuple[float, float]:
    """(bytes, operations) of one attention forward: q read, the K/V rows
    some query can see read once, the output written; 2·D multiply-adds
    per visible pair, for Q·Kᵀ and P·V."""
    kv_rows = 0
    for off in offsets:
        last = T if not causal else min(T, max(off + S, prefix or 0))
        first = max(0, off - window + 1) if window > 0 else 0
        kv_rows += max(last - first, 0)
    nbytes = 2 * B * S * Hq * D * elt + 2 * kv_rows * Hkv * D * elt
    pairs = visible_pairs(S, T, offsets, causal, window, prefix)
    return nbytes, 4 * D * Hq * pairs


def bound_ms(q, k, offsets, causal, window, prefix):
    """Attention's least time: bytes (q read, the K/V rows some query can
    see read once, the output written) or operations (2·D multiply-adds
    per visible pair, for Q·Kᵀ and P·V), counted for this run's
    offsets."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    return bound_of(*attention_work(B, S, T, Hq, Hkv, D, q.element_size(),
                                    offsets, causal, window, prefix),
                    q.dtype)


def attention_bwd_work(B: int, S: int, T: int, Hq: int, Hkv: int, D: int,
                       elt: int, causal, window, prefix
                       ) -> Tuple[float, float]:
    """(bytes, operations) of one attention backward at offset 0: q, k,
    v, o, dO and lse read once, dq, dk and dv written once; 2.5x the
    forward's 4·D multiply-adds per visible pair."""
    nbytes = (4 * B * S * Hq * D + 4 * B * T * Hkv * D) * elt \
        + B * Hq * S * 4
    pairs = visible_pairs(S, T, [0] * B, causal, window, prefix)
    return nbytes, 2.5 * 4 * D * Hq * pairs


def attn_bwd_bound(q, k, kw):
    """The backward's least time: bytes (q, k, v, o, dO and lse read once,
    dq, dk and dv written once) or operations (2.5x the forward's 4·D
    multiply-adds per visible pair), at the dtype's peak."""
    B, S, Hq, D = q.shape
    return bound_of(*attention_bwd_work(
        B, S, k.shape[1], Hq, k.shape[2], D, q.element_size(), kw["causal"],
        kw["window"], kw["prefix_len"]), q.dtype)


# ---------------------------------------------------------------------------
# the MoE router (B3), its backward, the combine and its backward
# ---------------------------------------------------------------------------
def router_work(T: int, E: int, k: int, e_local: int, capacity: int
                ) -> Tuple[float, float]:
    """logits read; probs, w, idx, slot, src, load, prob_sum and z_sum
    written; per element a max, an exp, a sum, a divide and a compare per
    round."""
    return (8 * T * E + 12 * T * k + 4 * e_local * capacity + 8 * E + 4,
            (4 + 2 * k) * T * E)


def router_bound(T: int, E: int, k: int, e_local: int, capacity: int):
    return bound_of(*router_work(T, E, k, e_local, capacity),
                    torch.float32)


def router_bwd_work(T: int, E: int, k: int) -> Tuple[float, float]:
    """logits and probs read, idx, w and dw read, dprob_sum and dz_sum
    read, dlogits written; per element a max, an exp, a sum and a
    multiply-add or two (8 operations)."""
    return 12 * T * E + 12 * T * k + 4 * E + 4, 8 * T * E + 4 * T * k


def router_bwd_bound(T, E, k):
    """``router_bwd_work`` at the CUDA cores' f32 rate."""
    return bound_of(*router_bwd_work(T, E, k), torch.float32)


def combine_kept(slot, n_slots) -> int:
    """The assignments that hold a slot: counted from ``slot`` where it
    holds data; for a fake one every assignment, up to the slots."""
    if is_fake(slot):
        return min(slot.numel(), n_slots)
    return int((slot < n_slots).sum())


def combine_work(n_slots: int, d: int, T: int, k: int, size: int,
                 kept: int) -> Tuple[float, float]:
    """The kept rows of out_buf read, w and slot read, y written; a
    multiply-add per kept element."""
    return kept * d * size + 8 * T * k + T * d * size, 2 * kept * d


def combine_bound(out_buf, slot):
    """``combine_work`` at the CUDA cores' f32 rate."""
    (n_slots, d), (T, k) = out_buf.shape, slot.shape
    return bound_of(*combine_work(n_slots, d, T, k, out_buf.element_size(),
                                  combine_kept(slot, n_slots)),
                    torch.float32)


def combine_bwd_work(n_slots: int, d: int, T: int, k: int, E: int,
                     size: int, kept: int) -> Tuple[float, float]:
    """dy and the kept rows of out_buf read, every row of d_out_buf
    written; w, slot, idx, src, logits and probs read, dlogits written;
    per kept element a multiply-add (dw) and a multiply (d_out), and the
    router's row (``router_bwd_work``'s operations)."""
    nbytes = ((T + kept + n_slots) * d * size + 12 * T * k + 4 * n_slots
              + 12 * T * E + 4 * E + 4)
    return nbytes, 3 * kept * d + 8 * T * E + 4 * T * k


def combine_bwd_bound(out_buf, slot, E):
    """``combine_bwd_work`` at the CUDA cores' f32 rate."""
    (n_slots, d), (T, k) = out_buf.shape, slot.shape
    return bound_of(*combine_bwd_work(n_slots, d, T, k, E,
                                      out_buf.element_size(),
                                      combine_kept(slot, n_slots)),
                    torch.float32)


# ---------------------------------------------------------------------------
# the SSD (B4) and its backward
# ---------------------------------------------------------------------------
def ssd_work(Bb: int, S: int, H: int, P: int, G: int, N: int, elt: int,
             has_D: bool, has_h0: bool) -> Tuple[float, float]:
    """Bytes (x, dt, B and C read once, y written, A, D, h0 read and
    h_final written) and operations of the function, not of an algorithm
    for it: per token and head, the recurrent form's P.N multiply-adds of
    the state update and P.N of C.h^T, plus P for the D skip, at 2
    operations a multiply-add.  A chunked algorithm's in-chunk C.B^T and
    score.x products are not counted: they are work that a chunk length
    chooses, not work the function needs."""
    nbytes = (2 * Bb * S * H * P + 2 * Bb * S * G * N) * elt \
        + 4 * Bb * S * H + 4 * H * (1 + has_D) \
        + 4 * Bb * H * P * N * (1 + has_h0)
    return nbytes, 2 * Bb * S * H * (2 * P * N + P * has_D)


def ssd_bound(x, B, has_D, has_h0):
    """``ssd_work``.  The kernels' products run on the tensor cores in
    3xTF32 (f32 and bf16 inputs alike), so the operations count at
    TF32's peak."""
    Bb, S, H, P = x.shape
    return bound_of(*ssd_work(Bb, S, H, P, B.shape[2], B.shape[3],
                              x.element_size(), has_D, has_h0),
                    x.dtype, peak=TF32_OPS_PER_S)


def ssd_bwd_work(Bb: int, S: int, H: int, P: int, G: int, N: int,
                 elt: int, has_D, has_h0, has_dh, nc: int
                 ) -> Tuple[float, float]:
    """Bytes (x, dy, B, C, dt read, the forward's entering states and
    decays read, A, D, h0 and dh_final read; dx, dB, dC, ddt, dA, dD
    written) and operations of the recurrent form's backward: per token
    and head 5 P.N multiply-adds (dh += dy (x) C, dC = h^T dy, dx = dh B,
    dB = dh^T x, the decay's sum of dh * h) and 2 P for D, at 2
    operations a multiply-add."""
    nbytes = (3 * Bb * S * H * P + 4 * Bb * S * G * N) * elt \
        + 8 * Bb * S * H + 4 * H * (2 + 2 * has_D) \
        + 4 * Bb * H * P * N * (has_h0 + has_dh)
    if nc > 1:
        nbytes += 4 * Bb * nc * H * (P * N + 1)
    return nbytes, 2 * Bb * S * H * (5 * P * N + 2 * P * has_D)


def ssd_bwd_bound(x, B, has_D, has_h0, has_dh, nc):
    """``ssd_bwd_work``, at TF32's peak as the forward's (3xTF32 keeps f32
    accuracy on the tensor cores)."""
    Bb, S, H, P = x.shape
    return bound_of(*ssd_bwd_work(Bb, S, H, P, B.shape[2], B.shape[3],
                                  x.element_size(), has_D, has_h0, has_dh,
                                  nc), x.dtype, peak=TF32_OPS_PER_S)


# ---------------------------------------------------------------------------
# the RG-LRU (B5) and its backward
# ---------------------------------------------------------------------------
def rglru_work(Bb: int, S: int, W: int, elt: int, has_h0,
               nc_kept: int = 1) -> Tuple[float, float]:
    """Bytes (x and two gates read, h written, lambda and h0 read,
    h_final written; training's forward also writes the f32 states
    entering its ``nc_kept`` > 1 chunks) and operations, 15 an element
    (two sigmoids of an exp, an add and a divide; three multiplies, two
    exps, a subtract, a max, a sqrt, a multiply-add)."""
    n = Bb * S * W
    nbytes = 4 * n * elt + 4 * W + 4 * Bb * W * (1 + has_h0) \
        + 4 * Bb * W * nc_kept * (nc_kept > 1)
    return nbytes, 15 * n


def rglru_bound(x, has_h0, nc_kept=1):
    """``rglru_work`` at the dtype's peak."""
    Bb, S, W = x.shape
    return bound_of(*rglru_work(Bb, S, W, x.element_size(), has_h0,
                                nc_kept), x.dtype)


def rglru_bwd_work(Bb: int, S: int, W: int, elt: int, has_h0, has_dh,
                   nc: int) -> Tuple[float, float]:
    """Bytes (x, the two gates and dh read, dx and the gates' gradients
    written, in x's dtype; lambda, h0, dh_final and the forward's kept
    states read, dlambda and dh0 written, f32; the kernel's own scratch
    not counted) and operations, 30 an element (the forward's 15 to
    rebuild h and a, and the reverse step's products)."""
    n = Bb * S * W
    nbytes = 7 * n * elt + 8 * W + 4 * Bb * W * (has_h0 + has_dh + 1) \
        + 4 * Bb * W * nc * (nc > 1)
    return nbytes, 30 * n


def rglru_bwd_bound(x, has_h0, has_dh, nc):
    """``rglru_bwd_work`` at the CUDA cores' f32 rate."""
    Bb, S, W = x.shape
    return bound_of(*rglru_bwd_work(Bb, S, W, x.element_size(), has_h0,
                                    has_dh, nc), torch.float32)


# ---------------------------------------------------------------------------
# the LM head's cross entropy
# ---------------------------------------------------------------------------
def cross_entropy_work(R: int, V: int, elt: int, grad, softcap
                       ) -> Tuple[float, float]:
    """Bytes (the (R, V) logits read once, with ``grad`` the gradient
    written once over them; the int64 targets and token count read, the
    f32 lse, nll and lse² written) and operations: per logit 4 for the lse
    (a max, a subtract, an exp, an add), 4 more for the gradient (a
    subtract, an exp, a multiply-add, the one-hot's compare), and under a
    softcap 3 (a divide, a tanh, a multiply) and 2 for its derivative."""
    n = R * V
    nbytes = n * elt * (1 + bool(grad)) + 8 * R + 8 + 12 * R
    per = 4 + 4 * bool(grad) + bool(softcap) * (3 + 2 * bool(grad))
    return nbytes, per * n


def cross_entropy_bound(R: int, V: int, dtype, grad, softcap):
    """``cross_entropy_work`` at the CUDA cores' f32 rate."""
    return bound_of(*cross_entropy_work(
        R, V, torch.empty((), dtype=dtype).element_size(), grad, softcap),
        torch.float32)


# ---------------------------------------------------------------------------
# Fletcher-64 (B2)
# ---------------------------------------------------------------------------
def fletcher_bound(xs: Iterable[torch.Tensor]):
    """Every byte and the table (3 words a shard and one) read once, 8
    bytes a shard written; two integer multiply-adds a word (s1 and sum
    i*w), counted at the CUDA cores' f32 rate."""
    xs = list(xs)
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    words = sum((x.numel() * x.element_size() + 3) // 4 for x in xs)
    return bound_of(nbytes + 32 * len(xs) + 8, 2 * words, torch.float32)
