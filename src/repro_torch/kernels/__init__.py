"""The port's kernels: hand-written Hopper kernels, each beside the plain
PyTorch version that the CPU runs and the card is checked against.

``attention`` (``csrc/flash_attention.cu``) — the attention forward for
prefill, prefill chunks and decode; (``csrc/flash_attention_bwd.cu``) its
backward, for training.
``moe_router`` (``csrc/moe_router.cu``) — softmax top-k routing and the
capacity dispatch of every MoE layer call, in one launch; and the
logits' gradient, for callers outside the MoE layer.
``moe_combine`` (``csrc/moe_combine.cu``) — each token's weighted sum of
its experts' outputs, in one launch; its backward, with the logits'
gradient, in one launch, for training.
``fletcher`` (``csrc/fletcher64.cu``) — the Fletcher-64 checksums of a
batch of checkpoint shards, in one launch pair.
``ssd`` (``csrc/ssd.cu``) — the Mamba2 SSD scan of every SSD layer's
prefill; (``csrc/ssd_bwd.cu``) its backward, for training.
``rglru`` (``csrc/rglru_scan.cu``) — the RG-LRU recurrence of every
RG-LRU layer's prefill and training forward; (``csrc/rglru_bwd.cu``) its
backward, for training.
``cross_entropy`` (``csrc/cross_entropy.cu``) — the LM head's cross
entropy over a chunk of rows: each row's lse and loss terms and, for
training, the logits' gradient over them, in one launch."""

# every CUDA source under csrc/, by the name build.build() takes
SOURCES = ("flash_attention", "flash_attention_bwd", "moe_router",
           "moe_combine", "fletcher64", "ssd", "ssd_bwd", "rglru_scan", "rglru_bwd",
           "cross_entropy")
