"""PyTorch + CUDA port of the ``repro`` serving stack for one NVIDIA H100.

The package stands alone: it imports ``torch``, ``numpy`` and the
standard library, never ``jax`` and nothing of ``repro``.  The RPC core
(``core/``), telemetry and configs are its own copies of the reference's
framework-free modules; models, the serve engine, the gateway and the
launcher are ports; ``kernels/`` holds the hand-written Hopper kernels.
Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``.
"""
