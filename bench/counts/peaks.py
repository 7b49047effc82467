"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, without
sparsity, at the full 700 W power limit: NVIDIA's data sheet.  A card
set to a lower power limit runs below them; the harness prints the
card's limit beside every result."""

PEAK_BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, ops: float, peak: float) -> float:
    """The least time a call can take: its bytes at the memory's rate or
    its operations at ``peak``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)
