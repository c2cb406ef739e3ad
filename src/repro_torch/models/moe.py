"""Mixture-of-Experts block on one device: the port of ``repro.models.moe``.

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

Only the JAX function's ``mesh=None`` branch has a counterpart: its
shard_map / expert-parallel / FSDP branches (``model_axis``,
``fsdp_axis``, ``fsdp_mode``) wait for sharded execution across devices.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

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
    t = x2d.shape[0]
    probs = torch.softmax(x2d.to(F32) @ router, dim=-1)  # [T, E]
    top_p, top_ids = top_k(probs, cfg.top_k)  # [T, k]
    top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True),
                                min=1e-9)
    # router weight of each token for each expert, [E, T]: JAX sums a
    # one-hot over k, whose one nonzero term is the weight itself
    w = torch.zeros(probs.shape, dtype=F32, device=x2d.device).scatter(
        1, top_ids, top_p).T
    return top_k(w, min(capacity(t, cfg), t))


def moe_apply_local(x2d: torch.Tensor, params: dict,
                    cfg: MoEConfig) -> torch.Tensor:
    """MoE over flat tokens ``x2d [T, D]``, every expert on this device."""
    d = x2d.shape[1]
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    e = w_gate.shape[0]
    gate_vals, tok_idx = route(x2d, params["router"], cfg)  # [E, C]
    flat = tok_idx.reshape(-1)
    xg = x2d[flat].reshape(e, -1, d)
    h = F.silu(torch.bmm(xg, w_gate)) * torch.bmm(xg, w_up)
    y = torch.bmm(h, w_down) * gate_vals[..., None].to(x2d.dtype)
    return torch.zeros_like(x2d).index_add(0, flat, y.reshape(-1, d))


def moe_apply(x: torch.Tensor, params: dict, cfg: MoEConfig) -> torch.Tensor:
    """MoE over ``x [..., D]`` (JAX's ``moe_apply`` with ``mesh=None``)."""
    shape = x.shape
    return moe_apply_local(x.reshape(-1, shape[-1]), params,
                           cfg).reshape(shape)
