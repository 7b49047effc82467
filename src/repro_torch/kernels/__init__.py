"""The port's kernels: hand-written Hopper kernels, each beside the plain
PyTorch version that the CPU runs and the card is checked against.

``attention`` (``csrc/flash_attention.cu``) — the attention forward for
prefill, prefill chunks and decode."""
