"""AdamW + schedules from scratch: the port of ``repro.train.optimizer``.

Written from the JAX package's formulas, not from ``torch.optim``: the
global-norm clip inside the update, warm-up then a cosine, linear or
constant decay, float32 math whatever the storage types, the bias
corrections ``1 - b ** step`` computed in float32, and weight decay on
every parameter (tables included).  Two storage options, as in JAX:

* ``momentum_dtype`` — storage type of m (float32 math, cast on store);
  ``"bfloat16"`` halves the largest optimizer buffer.
* ``factored_v`` — Adafactor-style factored second moment for parameters
  of rank >= 2: v ≈ (R ⊗ C) / mean(R), with R and C the row and column
  EMAs of g², stored as ``{"r": R, "c": C}``.

The JAX package keeps m and v as flat lists in ``jax.tree.leaves`` order;
the port keys them by parameter name (``OptState.m["cin.0"]``).
:func:`leaf_order` gives the names in JAX's leaf order, which the global
norm sums in and :func:`repro_torch.models.convert.load_jax_opt_state`
maps JAX's lists by.

``update`` writes the new parameters into the given tensors in place (the
model's own parameters when a module is passed) and returns a new state;
it never reads a value back to the host, so a step stays asynchronous.
``repro.train.optimizer.opt_state_partition_specs`` has no counterpart
yet: the port shards serving only (``distributed.sharding``), and its
optimizer state lives on one card until the model-parallel training
slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

F32 = torch.float32

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    schedule: str = "cosine"  # cosine | linear | constant
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    momentum_dtype: str = "float32"  # float32 | bfloat16
    factored_v: bool = False  # Adafactor-style factored second moment


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32, on the parameters' device
    m: Dict[str, torch.Tensor]
    v: Dict[str, Union[torch.Tensor, Dict[str, torch.Tensor]]]


def _name_key(name: str):
    # a dict level sorts its keys as strings, a list level by index
    return tuple(int(s) if s.isdigit() else s for s in name.split("."))


def leaf_order(names) -> list:
    """Parameter names in ``jax.tree.leaves`` order of the JAX pytree they
    come from: dict keys sorted, list entries by index."""
    return sorted(names, key=_name_key)


def named_params(params: Params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` in JAX leaf order, from a module or a mapping."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {n: params[n] for n in leaf_order(params)}


def make_schedule(cfg: OptimizerConfig
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (a 0-d tensor) → the learning rate, a float32 0-d tensor."""
    if cfg.schedule not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    warmup = float(max(cfg.warmup_steps, 1))
    span = float(max(cfg.decay_steps - cfg.warmup_steps, 1))

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = torch.clamp(step / warmup, max=1.0)
        t = torch.clamp((step - cfg.warmup_steps) / span, 0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * t))
        elif cfg.schedule == "linear":
            decay = 1.0 - (1 - cfg.min_lr_ratio) * t
        else:
            decay = torch.ones_like(t)
        return cfg.lr * warm * decay

    return sched


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in JAX leaf order."""
    total = None
    for name in leaf_order(tree):
        s = torch.sum(torch.square(tree[name].to(F32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every leaf (as float32) times ``min(1, max_norm / max(norm,
    1e-9))``; returns (clipped leaves, norm)."""
    norm = global_norm(tree)
    # a true division: ``scalar / tensor`` is a reciprocal times the scalar
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    return {n: g.to(F32) * scale for n, g in tree.items()}, norm


def _is_factored(p: torch.Tensor, cfg: OptimizerConfig) -> bool:
    return cfg.factored_v and p.dim() >= 2


def _init_v(p: torch.Tensor, cfg: OptimizerConfig):
    if _is_factored(p, cfg):
        return {"r": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                 device=p.device)}
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _update_v(v, g2: torch.Tensor, cfg: OptimizerConfig):
    """(new v state, the effective v̂ of the update)."""
    b2 = cfg.b2
    if isinstance(v, dict):
        r = b2 * v["r"] + (1 - b2) * torch.mean(g2, dim=-1)
        c = b2 * v["c"] + (1 - b2) * torch.mean(g2, dim=-2)
        denom = torch.clamp(torch.mean(r, dim=-1, keepdim=True), min=1e-30)
        vhat = (r / denom)[..., None] * c[..., None, :]
        return {"r": r, "c": c}, vhat
    v = b2 * v + (1 - b2) * g2
    return v, v


def adamw(cfg: OptimizerConfig):
    """``(init, update)``.

    * ``init(params) → OptState``: step 0, m and v zero, on the
      parameters' device.
    * ``update(grads, state, params) → (params, state, {"grad_norm",
      "lr"})``: ``grads`` maps every parameter name to its gradient; the
      new parameter values are written into ``params`` in place.
    """
    sched = make_schedule(cfg)
    m_dtype = getattr(torch, cfg.momentum_dtype)

    def init(params: Params) -> OptState:
        leaves = named_params(params)
        dev = next(iter(leaves.values())).device
        return OptState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={n: torch.zeros(p.shape, dtype=m_dtype, device=p.device)
               for n, p in leaves.items()},
            v={n: _init_v(p, cfg) for n, p in leaves.items()})

    @torch.no_grad()
    def update(grads: Mapping[str, torch.Tensor], state: OptState,
               params: Params):
        leaves = named_params(params)
        if grads.keys() != leaves.keys():
            raise KeyError(f"gradients and parameters differ: "
                           f"{sorted(grads.keys() ^ leaves.keys())}")
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        step = state.step + 1
        lr = sched(step)
        step_f = step.to(F32)
        b1c = 1 - torch.pow(cfg.b1, step_f)
        b2c = 1 - torch.pow(cfg.b2, step_f)
        new_m, new_v = {}, {}
        for name, p in leaves.items():
            g = grads.pop(name)
            mf = cfg.b1 * state.m[name].to(F32) + (1 - cfg.b1) * g
            v_state, vhat = _update_v(state.v[name], torch.square(g), cfg)
            delta = (mf / b1c) / (torch.sqrt(vhat / b2c) + cfg.eps)
            delta = delta + cfg.weight_decay * p.to(F32)
            p.copy_((p.to(F32) - lr * delta).to(p.dtype))
            new_m[name] = mf.to(m_dtype)
            new_v[name] = v_state
            del g, mf, vhat, delta
        return params, OptState(step=step, m=new_m, v=new_v), {
            "grad_norm": gnorm, "lr": lr}

    return init, update
