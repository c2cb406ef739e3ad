"""Architecture registry: every ported arch is a selectable config.

The counterpart of ``repro.launch.api``.  Each ``configs/<id>.py`` exposes
``ARCH: ArchDef``.  An ArchDef knows how to build its full (paper-exact)
and smoke (reduced) model configs, and how to build the step function of
each of its shapes on one device, or sharded over a ``DeviceMesh``
(``launch.mesh``; the serving kinds, see ``launch.steps``).  Every arch
of the JAX package is registered: the five LMs (family ``lm``), the four
recsys archs, GatedGCN (family ``gnn``) and the paper's own evaluator
(``pytrec-eval``, family ``eval``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    meta: Tuple[Tuple[str, Any], ...] = ()
    skip_reason: Optional[str] = None  # e.g. long_500k on full attention

    def get(self, key, default=None):
        return dict(self.meta).get(key, default)


class TensorSpec(NamedTuple):
    """Shape and dtype of one step argument (``jax.ShapeDtypeStruct``'s
    counterpart)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class StepBundle:
    """One (arch × shape) step on one device.

    ``arg_specs`` mirrors ``step_fn``'s positional arguments as trees of
    :class:`TensorSpec`: the module's parameters by name first (the JAX
    step's ``params`` slot), then for a ``train`` kind the optimizer state
    (``train.optimizer.OptState``), then the inputs.  Inputs are expected
    on ``device``.  A ``train`` step is ``step_fn(model, opt_state,
    batch) → (model, opt_state, metrics)``: the model's parameters are
    updated in place, ``metrics`` holds 0-d tensors on the device.
    """

    step_fn: Callable
    arg_specs: Tuple
    device: torch.device
    #: ``train`` kinds: ``init_opt(params) → OptState`` (the optimizer's
    #: zero state on the parameters' device), the step's second argument
    init_opt: Optional[Callable] = None
    #: the ``DeviceMesh`` the step is sharded over (None: one device)
    mesh: Optional[Any] = None


@dataclasses.dataclass
class ArchDef:
    name: str
    family: str  # lm | recsys | gnn | eval
    shapes: Dict[str, ShapeSpec]
    make_config: Callable[[bool], Any]  # (smoke: bool) -> model config
    # (cfg, shape, device=None, mesh=None) -> StepBundle; None → CUDA
    make_step: Callable[..., StepBundle]
    notes: str = ""


_REGISTRY: Dict[str, ArchDef] = {}


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.name] = arch
    return arch


def get_arch(name: str) -> ArchDef:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # Import for side effect: each module registers its ARCH.  Always run
    # (a module imported directly registers only itself; a repeated
    # import is a dictionary lookup).
    from repro_torch.configs import (  # noqa: F401
        arctic_480b,
        autoint,
        gatedgcn,
        mind,
        nemotron_4_15b,
        olmo_1b,
        phi3_medium_14b,
        pytrec_paper,
        qwen3_moe_235b,
        sasrec,
        xdeepfm,
    )


_NP_TO_TORCH = {np.dtype(np.int32): torch.int32,
                np.dtype(np.bool_): torch.bool,
                np.dtype(np.float32): torch.float32}


def to_device(tree, device):
    """A dict (or tuple) of numpy arrays → the same tree of tensors on
    ``device``, keeping int32 / bool / float32."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype not in _NP_TO_TORCH:
        raise TypeError(f"unsupported input dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, order="C")).to(device)
