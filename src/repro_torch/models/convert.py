"""Carry the JAX package's recsys weights into the port's modules.

The JAX package keeps parameters as a pytree of nested dicts and lists;
the port's modules name theirs after the same paths (``cin.0``,
``attn.1.wq``, ``blocks.wqkv``) with the same layouts, so carrying a
pytree across is a copy.  The caller turns the pytree's leaves into numpy
arrays first (``jax.tree.map(np.asarray, params)``); nothing here imports
JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn


def flatten_params(params: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict / list pytree → ``{"a.0.b": array}``."""
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        return {prefix: np.asarray(params)}
    out: Dict[str, np.ndarray] = {}
    for key, value in items:
        out.update(flatten_params(value, f"{prefix}.{key}" if prefix
                                  else str(key)))
    return out


def load_jax_params(module: nn.Module, params: Any) -> nn.Module:
    """Fill ``module``'s parameters in place from a JAX pytree of numpy
    arrays.  Raises ``KeyError`` on a missing or extra leaf and
    ``ValueError`` on a mis-shaped one, before anything is copied."""
    flat = flatten_params(params)
    own = dict(module.named_parameters())
    missing = sorted(own.keys() - flat.keys())
    extra = sorted(flat.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing}, "
                       f"extra {extra}")
    for name, p in own.items():
        if flat[name].shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {flat[name].shape} != "
                             f"{tuple(p.shape)}")
    with torch.no_grad():
        for name, p in own.items():
            src = torch.from_numpy(np.array(flat[name], order="C"))
            p.copy_(src.to(p.dtype))
    return module
