"""Mixture-of-Experts block: the port of ``repro.models.moe``, on one device
or expert-parallel over a ``DeviceMesh``.

Top-k routing, capacity dispatch, expert GEMMs.  Each expert takes its top
``C = cf · T · k / E`` tokens by router weight (drop-lowest-probability
policy; ``max(C, 1)``, then ``min(C, T)``, as JAX computes it); a dropped
token passes through the residual stream only.  The router is float32
whatever the model's type.

``lax.top_k`` gives ties to the lower index, and the capacity top-k over
the ``[E, T]`` router weights is full of exact zeros whenever C exceeds an
expert's routed tokens, so :func:`top_k` is a stable descending sort and a
slice (``torch.topk`` promises no order among ties).  JAX's
``out.at[idx].add(y)`` is ``index_add``: on CUDA it adds with atomics, in
no fixed order, so a token's expert outputs agree with JAX within a
tolerance, not bit for bit.

With a ``DeviceMesh`` (:func:`moe_apply`'s ``mesh``) the block runs as
JAX's ``shard_map`` body does, on each rank's local tensors
(``distributed.spmd``'s collectives): tokens sharded over the data axes
and replicated over ``model``, experts sharded over ``model`` (EP: rank
r holds experts ``[r · E_loc, (r + 1) · E_loc)`` and takes their
capacity top-k from the router weights of its tokens), then one sum over
``model``.  With ``fsdp_axis`` the expert FFN dimension is also split
over that data axis: ``"gather"`` all-gathers the weights,
``"activation"`` all-gathers the tokens over the axis, computes the
partial FFN with the local F block (SwiGLU is elementwise in F) and
reduce-scatters the outputs back.  Capacity comes from the tokens a
rank routes (its data shard's, or the gathered ones in ``activation``
mode), as in JAX, so with more than one data rank the sharded block is
JAX's ``moe_apply_local`` on each data shard, not the unsharded block.

Under autograd (training, ``gather`` mode as JAX trains) the weights'
all-gather over the FSDP axis reduce-scatters their gradients back to
the blocks, the sum over ``model`` passes the cotangent through, and the
replicated router enters each rank's experts through ``spmd.fan_out``
(its gradient summed over ``model``; the tokens' is summed by the
caller, ``transformer._ffn_sharded``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.models.layers import normal_in_dtype

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: parallel dense MLP branch
    router_dtype: str = "float32"


def init_moe(gen: torch.Generator | None, d_model: int, cfg: MoEConfig,
             dtype=F32, device=None) -> dict:
    e, f = cfg.n_experts, cfg.d_ff_expert
    s_in, s_out = (1.0 / d_model) ** 0.5, (1.0 / f) ** 0.5

    def draw(shape, scale, dt):
        return normal_in_dtype(gen, shape, scale, dt, device)

    return {"router": draw((d_model, e), s_in, F32),
            "w_gate": draw((e, d_model, f), s_in, dtype),
            "w_up": draw((e, d_model, f), s_in, dtype),
            "w_down": draw((e, f, d_model), s_out, dtype)}


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(c, 1)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest values, descending,
    ties to the lower index; returns (values, int64 indices)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(x2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Each expert's tokens: (gate values ``[E, C]`` float32, token
    indices ``[E, C]`` int64), from the float32 router on ``x2d [T, D]``."""
    return route_experts(x2d, router, cfg, 0, cfg.n_experts)


def route_experts(x2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
                  first: int, count: int):
    """:func:`route` for experts ``[first, first + count)`` only (each
    expert's capacity top-k is its own)."""
    t = x2d.shape[0]
    probs = torch.softmax(x2d.to(F32) @ router, dim=-1)  # [T, E]
    top_p, top_ids = top_k(probs, cfg.top_k)  # [T, k]
    top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True),
                                min=1e-9)
    # router weight of each token for each expert, [E, T]: JAX sums a
    # one-hot over k, whose one nonzero term is the weight itself
    w = torch.zeros(probs.shape, dtype=F32, device=x2d.device).scatter(
        1, top_ids, top_p).T[first:first + count]
    return top_k(w, min(capacity(t, cfg), t))


def _expert_ffn(x2d, w_gate, w_up, w_down, gate_vals, tok_idx):
    d = x2d.shape[1]
    flat = tok_idx.reshape(-1)
    xg = x2d[flat].reshape(w_gate.shape[0], -1, d)
    h = F.silu(torch.bmm(xg, w_gate)) * torch.bmm(xg, w_up)
    y = torch.bmm(h, w_down) * gate_vals[..., None].to(x2d.dtype)
    return torch.zeros_like(x2d).index_add(0, flat, y.reshape(-1, d))


def moe_apply_local(x2d: torch.Tensor, params: dict, cfg: MoEConfig, *,
                    mesh=None, model_axis=None, fsdp_axis=None,
                    fsdp_mode: str = "gather") -> torch.Tensor:
    """MoE over flat tokens ``x2d [T, D]``: every expert on this device
    (``mesh=None``), or this rank's shard of JAX's ``shard_map`` body,
    ``params['w_*']`` holding the local experts (leading dim E_loc) and,
    with ``fsdp_axis``, the local F block; the router is replicated."""
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    if mesh is None:
        gate_vals, tok_idx = route(x2d, params["router"], cfg)  # [E, C]
        return _expert_ffn(x2d, w_gate, w_up, w_down, gate_vals, tok_idx)
    activation = fsdp_axis is not None and fsdp_mode == "activation"
    if fsdp_axis is not None and fsdp_mode == "gather":
        w_gate = spmd.all_gather(w_gate, 2, mesh, fsdp_axis)
        w_up = spmd.all_gather(w_up, 2, mesh, fsdp_axis)
        w_down = spmd.all_gather(w_down, 1, mesh, fsdp_axis)
    if activation:
        x2d = spmd.all_gather(x2d, 0, mesh, fsdp_axis)
    e_loc = w_gate.shape[0]
    first = spmd.axis_index(mesh, model_axis) * e_loc
    # each rank's gradient reaches the router through its experts only
    router = spmd.fan_out(params["router"], mesh, model_axis)
    gate_vals, tok_idx = route_experts(x2d, router, cfg, first, e_loc)
    out = _expert_ffn(x2d, w_gate, w_up, w_down, gate_vals, tok_idx)
    if activation:
        # partial over the F blocks: summed and re-sharded in one step
        out = spmd.psum_scatter(out, 0, mesh, fsdp_axis)
    return spmd.psum(out, mesh, model_axis)


def moe_apply(x: torch.Tensor, params: dict, cfg: MoEConfig, *, mesh=None,
              model_axis: str = "model", fsdp_axis=None,
              fsdp_mode: str = "gather") -> torch.Tensor:
    """MoE over ``x [..., D]``; with a mesh, ``x`` and the expert weights
    are this rank's local blocks (see the module docstring)."""
    shape = x.shape
    return moe_apply_local(x.reshape(-1, shape[-1]), params, cfg, mesh=mesh,
                           model_axis=model_axis, fsdp_axis=fsdp_axis,
                           fsdp_mode=fsdp_mode).reshape(shape)
