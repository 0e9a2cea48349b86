"""PyTorch/CUDA port of the Binary Bleed reproduction.

Mirrors the layout of the JAX package ``repro``: ``core`` (search layer and
scoring), ``factorization`` (NMF, NMFk, batched planes), ``kernels``
(hand-written CUDA kernels for Hopper with their plain PyTorch versions),
``launch`` (the k-search driver) and ``obs`` (tracing and metrics).

Entry points run on the CUDA card unless the caller passes ``device="cpu"``;
functions on tensors follow the device of the tensors they are given. A
CUDA tensor always goes through the hand-written kernel, a CPU tensor
through its plain PyTorch version.
"""
