"""Gradient compression for the data-parallel all-reduce.

The port of ``repro.train.compression``, on tensors and on (nested) dicts
of tensors.  Two schemes, both applied around an explicit all-reduce
(see ``distributed.collectives.compressed_psum``):

* ``bf16``  — cast gradients to bfloat16 before the all-reduce.
* ``int8``  — per-leaf symmetric int8 quantization with **error feedback**:
  the quantization residual is carried to the next step, so the compressed
  SGD direction is unbiased over time (Karimireddy et al., 2019).

Every division is a true division by a tensor on the data's device (a
Python-scalar divisor becomes a multiply by its reciprocal on CUDA), and
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
payload, the scale and the error state are the same bits on the CPU, on
the card and in the JAX package.

>>> q, s, e = quantize_int8(torch.tensor([0.5, -1.0, 127.0]))
>>> q.tolist(), float(s), e.tolist()
([0, -1, 127], 1.0, [0.5, 0.0, 0.0])
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tensor or a (nested) dict of tensors,
    with the matching leaves of ``rest`` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a tensor or a (nested) dict of tensors, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (in key order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division on every device (a tensor divisor on
    ``x``'s device: CUDA turns a Python-scalar divisor into a multiply)."""
    return x / torch.full((), d, dtype=torch.float32, device=x.device)


def compress_bf16(g):
    return tree_map(lambda x: x.to(torch.bfloat16), g)


def decompress_bf16(g):
    return tree_map(lambda x: x.to(torch.float32), g)


def quantize_int8(x: torch.Tensor, error: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (+carried error) → (int8 values, fp scale, new error).

    In a distributed all-reduce the ``scale`` must be agreed on *before*
    quantizing (the max of every rank's local absmax): quantizing with
    local scales and dequantizing with a shared one is biased.  Pass the
    shared scale in.
    """
    xf = x.to(torch.float32)
    if error is not None:
        xf = xf + error
    if scale is None:
        scale = true_div(torch.clamp(torch.max(torch.abs(xf)), min=1e-12),
                         127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, xf - deq


def local_absmax(x: torch.Tensor,
                 error: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.to(torch.float32)
    if error is not None:
        xf = xf + error
    return torch.max(torch.abs(xf))


def init_error_state(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compress_grads_int8(grads, error_state):
    """Returns (tree of int8 values, tree of scales, new error state)."""
    out = [quantize_int8(g, e) for g, e in zip(tree_leaves(grads),
                                                tree_leaves(error_state))]
    return tuple(tree_unflatten(grads, [o[i] for o in out])
                 for i in range(3))


def decompress_grads_int8(qs, scales):
    return tree_map(lambda q, s: q.to(torch.float32) * s, qs, scales)
