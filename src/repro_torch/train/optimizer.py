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

Sharded (ZeRO) state.  :func:`opt_state_partition_specs` gives JAX's
specs of the state: m and v mirror the parameter specs, a factored v's
``r`` drops the last axis and ``c`` the one before it.  ``adamw(cfg,
mesh, specs, shapes)`` updates each rank's blocks in place: the global
norm sums each leaf's squares over the axes its spec splits (a
replicated leaf counts once), and a factored v's mean over a split axis
is the sum over the axis divided by the global length, so both equal the
unsharded values up to the order of the sums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd

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


def global_norm(tree: Mapping[str, torch.Tensor], mesh=None,
                specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in JAX leaf order.  With ``mesh`` the leaves are this rank's
    blocks laid out by ``specs``: the squares of the leaves split over
    the same axes are summed, then over those axes (one all-reduce for
    each set of axes), so a replicated leaf counts once."""
    groups: Dict[tuple, torch.Tensor] = {}
    for name in leaf_order(tree):
        s = torch.sum(torch.square(tree[name].to(F32)))
        axes = () if mesh is None else SH.split_axes(specs[name], mesh)
        groups[axes] = s if axes not in groups else groups[axes] + s
    total = None
    for axes, s in groups.items():
        s = spmd.psum(s, mesh, axes) if axes else s
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float,
                        mesh=None, specs=None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every leaf (as float32) times ``min(1, max_norm / max(norm,
    1e-9))``; returns (clipped leaves, norm)."""
    norm = global_norm(tree, mesh, specs)
    scale = _clip_scale(norm, max_norm)
    return {n: g.to(F32) * scale for n, g in tree.items()}, norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    # a true division: ``scalar / tensor`` is a reciprocal times the scalar
    return torch.clamp(torch.full_like(norm, max_norm)
                       / torch.clamp(norm, min=1e-9), max=1.0)


def _is_factored(p: torch.Tensor, cfg: OptimizerConfig) -> bool:
    return cfg.factored_v and p.dim() >= 2


def _init_v(p: torch.Tensor, cfg: OptimizerConfig):
    if _is_factored(p, cfg):
        return {"r": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                "c": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32,
                                 device=p.device)}
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def _mean(x: torch.Tensor, dim: int, keepdim: bool = False, split=None):
    """``torch.mean`` over ``dim``; ``split = (mesh, axes, n)``: ``dim`` is
    cut over ``axes`` (global length n), so the block's sum is summed
    over them and divided by n."""
    if not split or not split[1]:
        return torch.mean(x, dim=dim, keepdim=keepdim)
    mesh, axes, n = split
    return spmd.psum(torch.sum(x, dim=dim, keepdim=keepdim), mesh, axes) / n


def _update_v(v, g2: torch.Tensor, cfg: OptimizerConfig, last=None,
              second=None):
    """(new v state, the effective v̂ of the update).  ``last`` and
    ``second``: how the parameter's last two axes are split (see
    :func:`_mean`), for a factored v of a block."""
    b2 = cfg.b2
    if isinstance(v, dict):
        r = b2 * v["r"] + (1 - b2) * _mean(g2, -1, split=last)
        c = b2 * v["c"] + (1 - b2) * _mean(g2, -2, split=second)
        denom = torch.clamp(_mean(r, -1, True, second), min=1e-30)
        vhat = (r / denom)[..., None] * c[..., None, :]
        return {"r": r, "c": c}, vhat
    v = b2 * v + (1 - b2) * g2
    return v, v


def adamw(cfg: OptimizerConfig, mesh=None, specs=None, shapes=None):
    """``(init, update)``; with ``mesh`` the parameters, gradients and
    state are this rank's blocks, laid out by ``specs`` (``{name:
    spec}``) of parameters of global ``shapes`` (``{name: shape}``).

    * ``init(params) → OptState``: step 0, m and v zero, on the
      parameters' device.
    * ``update(grads, state, params) → (params, state, {"grad_norm",
      "lr"})``: ``grads`` maps every parameter name to its gradient; the
      new parameter values are written into ``params`` in place.
    """
    sched = make_schedule(cfg)
    m_dtype = getattr(torch, cfg.momentum_dtype)

    def _factor_split(name):
        """How the last two axes of parameter ``name`` are split."""
        if mesh is None or not cfg.factored_v or len(shapes[name]) < 2:
            return None, None
        spec = tuple(specs[name]) + (None,) * len(shapes[name])
        n = len(shapes[name])
        return tuple((mesh, SH.split_axes((spec[d],), mesh), shapes[name][d])
                     for d in (n - 1, n - 2))

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
        # clipped leaf by leaf below: one float32 gradient at a time
        grads = dict(grads)
        gnorm = global_norm(grads, mesh, specs)
        scale = _clip_scale(gnorm, cfg.clip_norm)
        step = state.step + 1
        lr = sched(step)
        step_f = step.to(F32)
        b1c = 1 - torch.pow(cfg.b1, step_f)
        b2c = 1 - torch.pow(cfg.b2, step_f)
        new_m, new_v = {}, {}
        for name, p in leaves.items():
            g = grads.pop(name).to(F32) * scale
            mf = cfg.b1 * state.m[name].to(F32) + (1 - cfg.b1) * g
            v_state, vhat = _update_v(state.v[name], torch.square(g), cfg,
                                      *_factor_split(name))
            delta = (mf / b1c) / (torch.sqrt(vhat / b2c) + cfg.eps)
            delta = delta + cfg.weight_decay * p.to(F32)
            p.copy_((p.to(F32) - lr * delta).to(p.dtype))
            new_m[name] = mf.to(m_dtype)
            new_v[name] = v_state
            del g, mf, vhat, delta
        return params, OptState(step=step, m=new_m, v=new_v), {
            "grad_norm": gnorm, "lr": lr}

    return init, update


def opt_state_partition_specs(param_specs: Mapping[str, tuple],
                              cfg: OptimizerConfig | None = None,
                              params=None) -> OptState:
    """The state's specs (ZeRO): m and v mirror ``param_specs`` (``{name:
    spec}``); with ``cfg.factored_v`` and ``params`` (``{name: tensor or
    TensorSpec}``, for the ranks) a factored leaf's spec is padded with
    None to the parameter's rank, then ``r`` drops its last entry and
    ``c`` the one before it.  JAX's ``opt_state_partition_specs`` leaf
    for leaf, keyed by name."""
    names = leaf_order(param_specs)
    m = {n: tuple(param_specs[n]) for n in names}
    v = dict(m)
    if cfg is not None and cfg.factored_v and params is not None:
        for n in names:
            if len(params[n].shape) >= 2:
                v[n] = _factored_spec(m[n], len(params[n].shape))
    return OptState(step=(), m=m, v=v)


def _factored_spec(spec, ndim: int):
    full = tuple(spec) + (None,) * (ndim - len(spec))
    return {"r": full[:-1], "c": full[:-2] + (full[-1],)}


def state_dtensors(state: OptState, param_specs, shapes, mesh) -> OptState:
    """A sharded state's blocks as DTensors laid out by
    :func:`opt_state_partition_specs` (for ``sharding.full_tensor`` and
    checkpoints); the step counter stays as it is."""

    def wrap(t, spec, shape):
        shape = tuple(shape)
        if isinstance(t, dict):  # r drops the last axis, c the one before
            spec = _factored_spec(spec, len(shape))
            shape = {"r": shape[:-1], "c": shape[:-2] + shape[-1:]}
            return {k: SH.from_local(t[k], spec[k], mesh, shape[k])
                    for k in t}
        return SH.from_local(t, spec, mesh, shape)

    return OptState(step=state.step,
                    m={n: wrap(state.m[n], param_specs[n], shapes[n])
                       for n in state.m},
                    v={n: wrap(state.v[n], param_specs[n], shapes[n])
                       for n in state.v})
