"""Shared building blocks: the port of ``repro.models.layers``.

Float32 math wherever JAX's is (norms, RoPE angles, softmax), cast back to
the input's type.  ``jax.nn.gelu`` defaults to the tanh approximation, so
``gelu_ffn`` asks ``F.gelu`` for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd

F32 = torch.float32


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


def normal_in_dtype(gen: torch.Generator | None, shape, scale: float,
                    dtype=F32, device=None) -> torch.Tensor:
    """Normal draws of standard deviation ``scale`` made directly in
    ``dtype`` (no float32 copy of a large tensor); ``gen=None`` only
    allocates."""
    out = torch.empty(shape, dtype=dtype, device=device)
    return out if gen is None else out.normal_(0.0, scale, generator=gen)


def nonparam_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale/bias), in float32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def norm(x: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """Dispatch: ``scale`` None → non-parametric LN, else RMSNorm."""
    if scale is None:
        return nonparam_layernorm(x)
    return rmsnorm(x, scale)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding, halves not interleaved.  x ``[..., S, n,
    head_dim]``, positions ``[..., S]``; angles in float32."""
    half = x.shape[-1] // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=F32,
                                           device=x.device) / half)
    angles = positions[..., None].to(F32) * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def squared_relu_ffn(x, w_up, w_down):
    return torch.square(torch.relu(x @ w_up)) @ w_down


def gelu_ffn(x, w_up, w_down):
    return F.gelu(x @ w_up, approximate="tanh") @ w_down


def softmax_fp32(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(logits.to(F32), dim=dim)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy ``[...]``: log-sum-exp of the float32
    logits ``[..., V]`` less the gold logit."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions; logits ``[..., V]``
    (log-sum-exp in float32), labels ``[...]`` int, ``label_mask``
    ``[...]`` bool (the mean is over its True entries, at least 1)."""
    nll = token_nll(logits, labels)
    if label_mask is None:
        return torch.mean(nll)
    m = label_mask.to(torch.float32)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, v0: int,
                       mesh, axis: str) -> torch.Tensor:
    """Per-position cross-entropy ``[...]`` of logits whose vocabulary is
    split over ``axis``: this rank holds columns ``[v0, v0 + V_loc)``
    (``logits [..., V_loc]``).  In float32: the row max is the max over
    ``axis`` of each rank's (a constant to autograd), the exp-sums are
    summed over ``axis``, and the gold logit comes from the rank that
    holds it (summed over ``axis``, each rank's zero elsewhere), so its
    gradient reaches that rank's column only.  With one rank on ``axis``
    this is :func:`token_nll`, op for op."""
    if spmd.axis_size(mesh, axis) == 1:
        return token_nll(logits, labels)
    lf = logits.to(torch.float32)
    top = (lf.detach().amax(-1, keepdim=True) if lf.shape[-1] else
           lf.new_full(lf.shape[:-1] + (1,), float("-inf")))
    top = spmd.psum(top, mesh, axis, op="max")
    logz = top[..., 0] + torch.log(spmd.psum(
        torch.sum(torch.exp(lf - top), dim=-1), mesh, axis))
    lab = labels.long()
    mine = (lab >= v0) & (lab < v0 + lf.shape[-1])
    at = torch.where(mine, lab - v0, torch.zeros_like(lab))
    gold = torch.gather(lf, -1, at[..., None])[..., 0]
    gold = spmd.psum(torch.where(mine, gold, torch.zeros_like(gold)), mesh,
                     axis)
    return logz - gold
