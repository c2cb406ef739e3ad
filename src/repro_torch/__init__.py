"""PyTorch/CUDA port of the repro evaluation engine (pytrec_eval on an H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core``, ``kernels``, ``distributed``) and never imports it or
JAX.  Entry points evaluate on CUDA unless the caller passes
``device="cpu"``; the two hand-written CUDA kernels (top-k and the fused
measure pass, under ``csrc/``) are built with ``nvcc`` at first use.
"""
