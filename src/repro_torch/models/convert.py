"""Carry the JAX package's weights and optimizer state into the port.

The JAX package keeps parameters as a pytree of nested dicts and lists;
the port's modules name theirs after the same paths (``cin.0``,
``attn.1.wq``, ``blocks.wqkv``, the stacked ``[L, ...]`` layers of
GatedGCN and the transformer: ``layers.w_node``, ``layers.wq``,
``layers.moe_gate``) with the same layouts, so carrying a pytree across
is a copy; bfloat16 leaves (``ml_dtypes`` arrays) carry their bits.  JAX's optimizer state keeps m and v as flat lists in
``jax.tree.leaves`` order; :func:`load_jax_opt_state` keys them by the
parameter names of that order.  The caller turns the pytrees' leaves into
numpy arrays first (``jax.tree.map(np.asarray, tree)``); nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch.train import optimizer as opt_lib


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
            p.copy_(_tensor(flat[name], "cpu", p.dtype))
    return module


def _tensor(x, device, dtype=None) -> torch.Tensor:
    arr = np.array(x, order="C")
    if arr.dtype.name == "bfloat16":  # ml_dtypes: carry the bits across
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def load_jax_opt_state(params_jax: Any, opt_state_jax: Any,
                       device="cpu") -> opt_lib.OptState:
    """JAX's ``OptState(step, m, v)`` (leaves as numpy arrays) → the
    port's, keyed by parameter name: the i-th entry of JAX's flat lists
    belongs to the i-th leaf of ``params_jax`` in ``jax.tree.leaves``
    order (:func:`repro_torch.train.optimizer.leaf_order`).  A factored
    second moment stays ``{"r": ..., "c": ...}``; m keeps its storage
    type (float32 or bfloat16).  Raises ``ValueError`` if the lists and
    the pytree differ in length or shape."""
    names = opt_lib.leaf_order(flatten_params(params_jax))
    step, m, v = opt_state_jax
    if len(m) != len(names) or len(v) != len(names):
        raise ValueError(f"{len(names)} parameters but {len(m)} m and "
                         f"{len(v)} v entries")
    flat = flatten_params(params_jax)
    for name, mi in zip(names, m):
        if np.shape(mi) != flat[name].shape:
            raise ValueError(f"{name}: m shape {np.shape(mi)} != "
                             f"{flat[name].shape}")
    return opt_lib.OptState(
        step=_tensor(step, device, torch.int32),
        m={n: _tensor(mi, device) for n, mi in zip(names, m)},
        v={n: ({k: _tensor(x, device) for k, x in vi.items()}
               if isinstance(vi, dict) else _tensor(vi, device))
           for n, vi in zip(names, v)})
