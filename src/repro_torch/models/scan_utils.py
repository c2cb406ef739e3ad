"""Layer stacks: the port of ``repro.models.scan_utils``.

The JAX package runs a stack of layers whose parameters are stacked on a
leading ``[L, ...]`` axis with ``lax.scan``.  PyTorch runs eagerly, so the
scan is a Python loop over that axis; the stacked layout stays, so weights
carry across from JAX leaf for leaf.  ``remat`` (JAX's ``jax.checkpoint``
of the body) becomes ``torch.utils.checkpoint`` of each layer: its
activations are recomputed in backward instead of kept.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch.utils.checkpoint import checkpoint


def scan_layers(body: Callable, carry, xs: Mapping[str, torch.Tensor],
                remat: bool = False):
    """``carry = body(carry, {k: xs[k][i]})`` for every layer i, in order;
    returns the last carry.  ``carry`` is a tuple of tensors."""
    length = next(iter(xs.values())).shape[0]
    for i in range(length):
        layer = {k: v[i] for k, v in xs.items()}
        if remat and torch.is_grad_enabled():
            carry = checkpoint(body, carry, layer, use_reentrant=False)
        else:
            carry = body(carry, layer)
    return carry
