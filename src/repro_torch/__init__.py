"""PyTorch/CUDA port of the repro evaluation engine (pytrec_eval on an H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core``, ``kernels``, ``distributed``) and never imports it or
JAX.  Entry points evaluate on CUDA unless the caller passes
``device="cpu"``; the hand-written CUDA kernels (top-k, the fused measure
pass, EmbeddingBag and its backward, under ``csrc/``) are built with
``nvcc`` at first use.
"""
