"""Shared building blocks: the recsys and GNN models' part of
``repro.models.layers``."""

from __future__ import annotations

import torch


def dense_init(gen: torch.Generator | None, d_in: int, d_out: int,
               dtype=torch.float32, scale=None, device=None) -> torch.Tensor:
    """``[d_in, d_out]`` normal weights times ``scale`` (default
    ``1/sqrt(d_in)``), drawn from ``gen`` on ``device``.  ``gen=None``
    allocates without drawing (for the ``meta`` device)."""
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    return normal(gen, (d_in, d_out), scale, dtype, device)


def normal(gen: torch.Generator | None, shape, scale: float,
           dtype=torch.float32, device=None) -> torch.Tensor:
    """Normal draws times ``scale``; ``gen=None`` only allocates."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=device)
    return (x * scale).to(dtype)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale/bias), in float32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions; logits ``[..., V]``
    (log-sum-exp in float32), labels ``[...]`` int, ``label_mask``
    ``[...]`` bool (the mean is over its True entries, at least 1)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if label_mask is None:
        return torch.mean(nll)
    m = label_mask.to(torch.float32)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
