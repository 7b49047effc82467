"""Each hand-written kernel's work from its shapes: (bytes, operations).

A frozen copy of ``repro_torch.kernels.cost``'s counts for the kernels
the cells drive.  Each input is counted read once and each output
written once, whatever a kernel reads again; where the work depends on
the data, the count is what these inputs need (the (query, key) pairs
the mask leaves visible).  The count does
not depend on how a kernel computes it.
"""
from __future__ import annotations

from typing import Iterable, Tuple

from .peaks import PEAK_BF16_FLOPS, PEAK_F32_FLOPS, least_seconds


def row_pairs(S: int, off: int) -> int:
    """Causal (query, key) pairs of S queries at positions off..off+S-1:
    query p sees keys 0..p."""
    return S * off + S * (S + 1) // 2


def attention_fwd(S: int, T: int, Hq: int, Hkv: int, D: int, elt: int,
                  offsets: Iterable[int]) -> Tuple[float, float]:
    """A causal attention forward over one row of queries per offset: q
    read and the output written, the K/V rows some query can see read
    once; 2·D multiply-adds a visible pair for Q·Kᵀ and for P·V."""
    offsets = list(offsets)
    kv_rows = sum(min(T, off + S) for off in offsets)
    nbytes = 2 * len(offsets) * S * Hq * D * elt + 2 * kv_rows * Hkv * D * elt
    pairs = sum(row_pairs(S, off) for off in offsets)
    return nbytes, 4 * D * Hq * pairs


def attention_bwd(B: int, S: int, Hq: int, Hkv: int, D: int, elt: int
                  ) -> Tuple[float, float]:
    """A causal attention backward at offset 0: q, k, v, o, dO and the row
    lse read once, dq, dk and dv written once; 2.5x the forward's 4·D
    multiply-adds a visible pair."""
    nbytes = (4 * B * S * Hq * D + 4 * B * S * Hkv * D) * elt + B * Hq * S * 4
    return nbytes, 2.5 * 4 * D * Hq * B * row_pairs(S, 0)


def least(work: Tuple[float, float], dtype: str) -> float:
    """Seconds at the card's peak for ``dtype`` ("bfloat16" on the tensor
    cores, anything else on the CUDA cores' f32 rate)."""
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    return least_seconds(work[0], work[1], peak)
