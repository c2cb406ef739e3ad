"""Decoder-only transformer LM, dense and MoE: the port of
``repro.models.transformer`` on one device.

Covers the five LM archs (olmo-1b, phi3-medium-14b, nemotron-4-15b,
qwen3-moe-235b, arctic-480b): GQA attention, RoPE, float32 softmax,
SwiGLU / squared-ReLU / tanh-GELU FFNs, MoE through :mod:`.moe`.

:class:`Transformer` keeps JAX's parameter names and layouts (``embed``
``[V, d]``, ``layers.wq`` ``[L, d, H·hd]``, …, ``layers.router``
``[L, d, E]`` float32, ``layers.moe_gate`` ``[L, E, d, fe]``,
``final_norm``, ``lm_head`` ``[d, V]``), so ``models.convert`` carries a
JAX tree across by copying.  The layer stack is ``scan_layers`` over the
stacked ``[L, ...]`` parameters, remat (``torch.utils.checkpoint``) when
``cfg.remat``.

Attention is computed as JAX computes it: query heads grouped by their KV
head ``[b, s, kv, rep, hd]``, scores in float32 divided by ``sqrt(hd)``,
masked with ``-1e30`` (not ``-inf``), softmax in float32, probabilities
cast to the model's type before the product with V.  The attention is
naive: a ``[B, H, S, S]`` float32 score tensor per layer.

Serving is ``prefill(tokens) → cache`` (padded to ``max_seq``), then
``decode_step(cache, token, pos)``, KV cache ``[L, B, KV, S, hd]``.
``decode_step`` writes the cache in place (JAX's step donates it); ``pos``
is a Python int, so the step reads nothing back from the device.  At
``pos >= max_seq`` JAX's ``dynamic_update_slice`` clamps the write to the
last slot and attends to every position; the port raises ``ValueError``.

``param_partition_specs`` and ``cache_partition_specs`` return JAX
``PartitionSpec``s and have no counterpart: the port runs on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import Parameter as P

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.scan_utils import scan_layers

F32 = torch.float32
MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    ffn: str = "swiglu"  # swiglu | sq_relu | gelu
    norm: str = "rmsnorm"  # rmsnorm | nonparam
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[moe_lib.MoEConfig] = None
    dtype: str = "float32"
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2

    def _dense_ffn_params(self) -> int:
        return (3 if self.ffn == "swiglu" else 2) * self.d_model * self.d_ff

    def _ffn_params(self, experts: int) -> int:
        if self.moe is None:
            return self._dense_ffn_params()
        d, fe = self.d_model, self.moe.d_ff_expert
        ffn = experts * 3 * d * fe + d * self.moe.n_experts
        if self.moe.dense_residual:
            ffn += self._dense_ffn_params()
        return ffn

    def _embed_params(self) -> int:
        return self.vocab_size * self.d_model * (
            1 if self.tie_embeddings else 2)

    def param_count(self) -> int:
        experts = self.moe.n_experts if self.moe is not None else 0
        return (self.n_layers * (self._attn_params()
                                 + self._ffn_params(experts))
                + self._embed_params())

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        return (self.n_layers * (self._attn_params()
                                 + self._ffn_params(self.moe.top_k))
                + self._embed_params())


class Transformer(nn.Module):
    """The model's parameters, drawn in the model's type (never through a
    float32 copy of a whole tensor) from a ``torch.Generator`` on an
    explicit device (CUDA by default; raises without it; ``meta``
    allocates nothing)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = None
        if dev.type != "meta":
            gen = generator or torch.Generator(device=dev).manual_seed(0)
        dt, n = cfg.torch_dtype, cfg.n_layers
        d, hd = cfg.d_model, cfg.head_dim
        n_q, n_kv = cfg.n_heads * hd, cfg.n_kv_heads * hd

        def stacked(shape, fan_in, dtype=dt):
            return P(L.normal_in_dtype(gen, (n,) + shape,
                                       (1.0 / fan_in) ** 0.5, dtype, dev))

        def ones(shape):
            return P(torch.ones(shape, dtype=dt, device=dev))

        lp = {"wq": stacked((d, n_q), d), "wk": stacked((d, n_kv), d),
              "wv": stacked((d, n_kv), d), "wo": stacked((n_q, d), n_q)}
        if cfg.norm == "rmsnorm":
            lp["attn_norm"] = ones((n, d))
            lp["ffn_norm"] = ones((n, d))
        if cfg.moe is None or cfg.moe.dense_residual:
            if cfg.ffn == "swiglu":
                lp["w_gate"] = stacked((d, cfg.d_ff), d)
            lp["w_up"] = stacked((d, cfg.d_ff), d)
            lp["w_down"] = stacked((cfg.d_ff, d), cfg.d_ff)
        if cfg.moe is not None:
            e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
            lp["router"] = stacked((d, e), d, F32)
            lp["moe_gate"] = stacked((e, d, fe), d)
            lp["moe_up"] = stacked((e, d, fe), d)
            lp["moe_down"] = stacked((e, fe, d), fe)
        self.embed = P(L.normal_in_dtype(gen, (cfg.vocab_size, d), 0.02, dt,
                                         dev))
        self.layers = nn.ParameterDict(lp)
        if cfg.norm == "rmsnorm":
            self.final_norm = ones((d,))
        if not cfg.tie_embeddings:
            self.lm_head = P(L.normal_in_dtype(gen, (d, cfg.vocab_size),
                                               (1.0 / d) ** 0.5, dt, dev))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def out_norm(self, x: torch.Tensor) -> torch.Tensor:
        return L.norm(x, getattr(self, "final_norm", None))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _dense_ffn(x, lp, cfg):
    if cfg.ffn == "swiglu":
        return L.swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    if cfg.ffn == "sq_relu":
        return L.squared_relu_ffn(x, lp["w_up"], lp["w_down"])
    return L.gelu_ffn(x, lp["w_up"], lp["w_down"])


def _ffn_block(x, lp, cfg):
    """FFN or MoE (+ arctic's parallel dense residual branch)."""
    if cfg.moe is None:
        return _dense_ffn(x, lp, cfg)
    out = moe_lib.moe_apply(x, {"router": lp["router"],
                                "w_gate": lp["moe_gate"],
                                "w_up": lp["moe_up"],
                                "w_down": lp["moe_down"]}, cfg.moe)
    if cfg.moe.dense_residual:
        out = out + _dense_ffn(x, lp, cfg)
    return out


def _qkv(x, lp, cfg, positions):
    """q ``[b, s, H, hd]`` and k, v ``[b, s, KV, hd]``, q and k roped."""
    b, s, _ = x.shape
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = L.rope((x @ lp["wq"]).reshape(b, s, h, hd), positions,
               cfg.rope_theta)
    k = L.rope((x @ lp["wk"]).reshape(b, s, kv, hd), positions,
               cfg.rope_theta)
    return q, k, (x @ lp["wv"]).reshape(b, s, kv, hd)


def _softmax_probs(scores, valid, dtype):
    """float32 ``scores / sqrt(hd)`` already taken; masked with -1e30
    where ``valid`` is False, softmax, cast to ``dtype``."""
    scores = scores.masked_fill_(~valid, MASK_VALUE)
    return torch.softmax(scores, dim=-1).to(dtype)


def _attend(q, k, v, cfg, dtype):
    """Causal GQA attention over the sequence: ``[b, s, H·hd]``."""
    b, s, h, hd = q.shape
    kv = cfg.n_kv_heads
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qg, k).to(F32)
    scores = scores.div_(hd ** 0.5)
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril_()
    probs = _softmax_probs(scores, causal, dtype)
    return torch.einsum("bkrqs,bskh->bqkrh", probs, v).reshape(b, s, h * hd)


def _layer(x, lp, cfg, positions):
    xn = L.norm(x, lp.get("attn_norm"))
    q, k, v = _qkv(xn, lp, cfg, positions)
    x = x + _attend(q, k, v, cfg, x.dtype) @ lp["wo"]
    return x + _ffn_block(L.norm(x, lp.get("ffn_norm")), lp, cfg)


def _positions(b, s, device):
    return torch.arange(s, device=device).expand(b, s)


def logits_train(params: Transformer, tokens: torch.Tensor,
                 cfg: TransformerConfig) -> torch.Tensor:
    """Full forward for training: tokens ``[B, S]`` → logits
    ``[B, S, V]``."""
    b, s = tokens.shape
    x = params.embed[tokens.long()]
    positions = _positions(b, s, tokens.device)
    x = scan_layers(lambda c, lp: _layer(c, lp, cfg, positions), x,
                    params.layers, cfg.remat)
    return params.out_norm(x) @ params.head()


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """Zero KV cache ``{"k", "v"}`` of ``[L, B, KV, max_seq, hd]`` on
    ``device`` (default CUDA)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    dev = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _attention_decode(x, lp, cfg, k_cache, v_cache, pos):
    """x ``[B, D]`` one new token; cache ``[B, KV, S, hd]`` written at
    ``pos`` in place."""
    b, _ = x.shape
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    posb = torch.full((b, 1), pos, device=x.device)
    q, k_new, v_new = _qkv(x[:, None, :], lp, cfg, posb)  # s = 1
    k_cache.narrow(2, pos, 1).copy_(k_new.transpose(1, 2))
    v_cache.narrow(2, pos, 1).copy_(v_new.transpose(1, 2))
    s = k_cache.shape[2]
    q = q.reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bkrh,bksh->bkrs", q, k_cache).to(F32)
    scores = scores.div_(hd ** 0.5)
    valid = torch.arange(s, device=x.device) <= pos
    probs = _softmax_probs(scores, valid, x.dtype)
    out = torch.einsum("bkrs,bksh->bkrh", probs, v_cache).reshape(b, h * hd)
    return out @ lp["wo"]


def decode_step(params: Transformer, cache: dict, token: torch.Tensor,
                pos: int, cfg: TransformerConfig):
    """One decode step: token ``[B]`` at position ``pos`` (a Python int
    below the cache's length) → (logits ``[B, V]``, the cache, written in
    place)."""
    max_seq = cache["k"].shape[3]
    pos = int(pos)
    if not 0 <= pos < max_seq:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{max_seq} slots")
    x = params.embed[token.long()]  # [B, D]

    def body(xc, lp):
        h = _attention_decode(L.norm(xc, lp.get("attn_norm")), lp, cfg,
                              lp["k_cache"], lp["v_cache"], pos)
        xc = xc + h
        return xc + _ffn_block(L.norm(xc, lp.get("ffn_norm"))[:, None, :],
                               lp, cfg)[:, 0, :]

    x = scan_layers(body, x, {**params.layers, "k_cache": cache["k"],
                              "v_cache": cache["v"]})
    return params.out_norm(x) @ params.head(), cache


def prefill(params: Transformer, tokens: torch.Tensor,
            cfg: TransformerConfig, max_seq: Optional[int] = None):
    """Prefill: tokens ``[B, S]`` → (last-position logits ``[B, V]``, KV
    cache padded with zeros to ``max_seq`` (default S))."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq or s, dtype=params.embed.dtype,
                       device=tokens.device)
    x = params.embed[tokens.long()]
    positions = _positions(b, s, tokens.device)

    def body(xc, lp):
        xn = L.norm(xc, lp.get("attn_norm"))
        q, k, v = _qkv(xn, lp, cfg, positions)
        lp["k_cache"][:, :, :s] = k.transpose(1, 2)  # [B, KV, S, hd]
        lp["v_cache"][:, :, :s] = v.transpose(1, 2)
        xc = xc + _attend(q, k, v, cfg, xc.dtype) @ lp["wo"]
        return xc + _ffn_block(L.norm(xc, lp.get("ffn_norm")), lp, cfg)

    x = scan_layers(body, x, {**params.layers, "k_cache": cache["k"],
                              "v_cache": cache["v"]})
    return params.out_norm(x[:, -1]) @ params.head(), cache
