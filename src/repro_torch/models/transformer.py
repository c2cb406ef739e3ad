"""Decoder-only transformer LM, dense and MoE: the port of
``repro.models.transformer``, on one device or (serving) sharded over a
``DeviceMesh``.

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

Model-parallel serving.  ``param_partition_specs`` and
``cache_partition_specs`` give JAX's specs (axis-name tuples, see
``distributed.sharding``), leaf for leaf, and :func:`shard_params` lays a
model out by them on a ``DeviceMesh`` (:class:`ShardedTransformer`: each
rank keeps views of its blocks).  ``prefill`` and ``decode_step`` with
``mesh``/``shd`` run on each rank's local blocks with explicit
collectives (``distributed.spmd``), as JAX's ``shard_map`` bodies would:

* the batch is split over the data axes; the embedding rows over
  ``model`` (a masked local gather, then a sum over ``model``);
* ``wq/wk/wv/w_gate/w_up`` are split by columns and ``wo/w_down`` by
  rows, one sum over ``model`` after each of attention and the FFN;
* attention runs on whole heads (JAX's ``act_heads`` constraint): where
  the column split cuts through heads (56 query heads or 8 KV heads over
  16 ranks) q is all-gathered and each rank takes its block of heads
  (torch.chunk's rule, as GSPMD pads), with the KV heads its query heads
  read; k and v are all-gathered for the cache, which holds every KV
  head;
* with ``shard_cache_seq`` the cache's sequence axis is split over
  ``model``: prefill writes each rank's slots, decode writes the new
  token on the rank that holds ``pos`` and combines the softmax over the
  ranks flash-decoding style (a float32 max and sum over ``model``, then
  the sum of the partial products with V);
* the logits are vocab-sharded (``shd.logits()``);
* MoE runs expert-parallel (``models.moe``).

They return what the unsharded functions return, as DTensors laid out
as JAX's ``out_shardings``: the logits ``(batch, model)`` and the cache
by ``cache_partition_specs`` (``sharding.full_tensor`` gives the unsharded
values).

Model-parallel training.  ``logits_train`` with ``mesh``/``shd`` runs
the same layers under autograd on the blocks of a
:class:`ShardedTransformer` (``shard_params(..., train=True)``: leaf
tensors of the rank's own) and returns this rank's block of the logits
(its rows, its vocabulary columns).  Each collective has its transpose
as backward (``distributed.spmd``): a replicated activation entering a
column-parallel product, the experts or the vocabulary columns passes
through ``spmd.fan_out`` (its gradient summed over ``model``), each sum
over ``model`` passes the cotangent through, the regroups' all-gathers
reduce-scatter it, and MoE's FSDP ``gather`` of the expert weights
reduce-scatters their gradients over the data axis.  Tied embeddings get
the lookup's and the head's gradients in one block.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.nn import Parameter as P

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
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
    kv = k.shape[2]
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
                 cfg: TransformerConfig, mesh=None,
                 shd: Optional[SH.LMSharding] = None) -> torch.Tensor:
    """Full forward for training: tokens ``[B, S]`` → logits
    ``[B, S, V]``.  With ``mesh`` and ``shd``: ``params`` a
    :class:`ShardedTransformer`, ``tokens`` the full batch (or a
    DTensor); returns this rank's block of the logits ``[B_loc, S,
    V_loc]`` (``shd.logits()``: its data shard's rows, its columns
    :func:`vocab_block` of the vocabulary)."""
    if mesh is not None:
        return _logits_train_sharded(params, tokens, cfg, mesh, shd)
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
                pos: int, cfg: TransformerConfig, mesh=None,
                shd: Optional[SH.LMSharding] = None):
    """One decode step: token ``[B]`` at position ``pos`` (a Python int
    below the cache's length) → (logits ``[B, V]``, the cache, written in
    place).  With ``mesh`` and ``shd``: ``params`` from
    :func:`shard_params`, the cache from the sharded :func:`prefill`."""
    max_seq = cache["k"].shape[3]
    pos = int(pos)
    if not 0 <= pos < max_seq:
        raise ValueError(f"decode position {pos} outside the cache's "
                         f"{max_seq} slots")
    if mesh is not None:
        return _decode_sharded(params, cache, token, pos, cfg, mesh, shd)
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
            cfg: TransformerConfig, max_seq: Optional[int] = None,
            mesh=None, shd: Optional[SH.LMSharding] = None):
    """Prefill: tokens ``[B, S]`` → (last-position logits ``[B, V]``, KV
    cache padded with zeros to ``max_seq`` (default S)).  With ``mesh``
    and ``shd``: ``params`` from :func:`shard_params`, ``tokens`` the full
    batch (or a DTensor), both results DTensors."""
    if mesh is not None:
        return _prefill_sharded(params, tokens, cfg, mesh, shd, max_seq)
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


# ---------------------------------------------------------------------------
# Model-parallel serving (see the module docstring)
# ---------------------------------------------------------------------------


def param_partition_specs(cfg: TransformerConfig, shd: SH.LMSharding):
    """JAX's spec tree for the parameters, leaf for leaf."""

    def batched(spec):  # layer-stacked params get a leading None axis
        return (None, *spec)

    lp = {"wq": batched(shd.p_attn_in()), "wk": batched(shd.p_attn_in()),
          "wv": batched(shd.p_attn_in()), "wo": batched(shd.p_attn_out())}
    if cfg.norm == "rmsnorm":
        lp["attn_norm"] = (None, None)
        lp["ffn_norm"] = (None, None)
    if cfg.moe is None or cfg.moe.dense_residual:
        if cfg.ffn == "swiglu":
            lp["w_gate"] = batched(shd.p_ffn_in())
        lp["w_up"] = batched(shd.p_ffn_in())
        lp["w_down"] = batched(shd.p_ffn_out())
    if cfg.moe is not None:
        lp["router"] = (None, None, None)
        lp["moe_gate"] = batched(shd.p_expert_in())
        lp["moe_up"] = batched(shd.p_expert_in())
        lp["moe_down"] = batched(shd.p_expert_out())
    specs = {"embed": shd.p_embed(), "layers": lp}
    if cfg.norm == "rmsnorm":
        specs["final_norm"] = (None,)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, shd.model_axis)
    return specs


def cache_partition_specs(cfg: TransformerConfig, shd: SH.LMSharding):
    spec = (None, *shd.cache())
    return {"k": spec, "v": spec}


def flat_partition_specs(cfg: TransformerConfig, shd: SH.LMSharding):
    """:func:`param_partition_specs` keyed by the parameters' dotted
    names (``layers.wq``)."""
    out = {}
    for top, spec in param_partition_specs(cfg, shd).items():
        if isinstance(spec, dict):
            out.update({f"{top}.{k}": v for k, v in spec.items()})
        else:
            out[top] = spec
    return out


class ShardedTransformer:
    """A :class:`Transformer`'s parameters laid out on a mesh by
    :func:`param_partition_specs`: ``params`` (a
    ``sharding.ShardedParams``) maps each name to this rank's block, the
    tensor a train step differentiates and updates in place;
    ``embed``, ``layers[name]``, ``final_norm`` and ``lm_head`` are those
    blocks."""

    def __init__(self, cfg: TransformerConfig, mesh, shd: SH.LMSharding,
                 params: SH.ShardedParams):
        self.cfg, self.mesh, self.shd, self.params = cfg, mesh, shd, params
        self.embed = params["embed"]
        self.layers = {k[len("layers."):]: v for k, v in params.items()
                       if k.startswith("layers.")}
        self.final_norm = params.get("final_norm")
        self.lm_head = params.get("lm_head")

    def local_layers(self) -> dict:
        return dict(self.layers)

    def local_head(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.embed.T
        return self.lm_head

    def out_norm(self, x: torch.Tensor) -> torch.Tensor:
        return L.norm(x, self.final_norm)


def shard_params(model: Transformer, mesh, shd: SH.LMSharding,
                 train: bool = False) -> ShardedTransformer:
    """``model`` laid out on ``mesh`` by ``shd``'s specs, with nothing
    communicated: for serving each block is a view of the model's
    parameter (every rank keeps the whole model); with ``train`` the
    blocks are the rank's own (``sharding.train_layout``: the model's
    split parameters are dropped), leaves under autograd."""
    specs = flat_partition_specs(model.cfg, shd)
    params = (SH.train_layout(model, specs, mesh) if train else
              SH.ShardedParams(model, specs, mesh))
    return ShardedTransformer(model.cfg, mesh, shd, params)


class _TP:
    """One sharded call's view of the ``model`` axis."""

    def __init__(self, cfg: TransformerConfig, mesh, shd: SH.LMSharding):
        self.cfg, self.mesh, self.shd = cfg, mesh, shd
        self.ax = shd.model_axis
        self.m = spmd.axis_size(mesh, self.ax)
        self.r = spmd.axis_index(mesh, self.ax)
        self.rep = cfg.n_heads // cfg.n_kv_heads

    def heads(self, r):
        """Query heads ``[h0, h1)`` of rank r (JAX's ``act_heads``)."""
        return SH.chunk_bounds(self.cfg.n_heads, self.m, r)

    def cols(self, n, r):
        return SH.chunk_bounds(n, self.m, r)

    def psum(self, x):
        return spmd.psum(x, self.mesh, self.ax)

    def regroup(self, x, n, want):
        """Columns of ``x`` (rank r's column block of ``n``) re-cut to
        ``want(r)``."""
        return spmd.regroup(x, -1, self.mesh, self.ax,
                            lambda r: self.cols(n, r), want)


def _embed_sharded(tp: _TP, embed_loc, tok):
    """Vocab-parallel lookup: each rank gathers the rows it holds (the
    rest zero) and the sum over ``model`` completes every row."""
    v0, v1 = tp.cols(tp.cfg.vocab_size, tp.r)
    hit = (tok >= v0) & (tok < v1)
    rows = torch.where(hit, tok - v0, torch.zeros_like(tok)).long()
    return tp.psum(embed_loc[rows] * hit[..., None].to(embed_loc.dtype))


def _qkv_sharded(tp: _TP, x, lp, positions, q_heads):
    """q ``[b, s, h1 - h0, hd]`` for the query heads ``q_heads(r) = (h0,
    h1)`` and k, v of every KV head ``[b, s, KV, hd]``, q and k roped,
    from the column blocks of ``x @ w``."""
    cfg = tp.cfg
    x = spmd.fan_out(x, tp.mesh, tp.ax)
    b, s, _ = x.shape
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h0, h1 = q_heads(tp.r)
    q = tp.regroup(x @ lp["wq"], h * hd,
                   lambda r: tuple(i * hd for i in q_heads(r)))
    every = lambda r: (0, kv * hd)  # noqa: E731
    k = tp.regroup(x @ lp["wk"], kv * hd, every).reshape(b, s, kv, hd)
    v = tp.regroup(x @ lp["wv"], kv * hd, every).reshape(b, s, kv, hd)
    q = L.rope(q.reshape(b, s, h1 - h0, hd), positions, cfg.rope_theta)
    return q, L.rope(k, positions, cfg.rope_theta), v


def _attend_heads(tp: _TP, q, k, v, dtype):
    """Causal attention of this rank's query heads over the KV heads they
    read: ``[b, s, (h1 - h0)·hd]``."""
    h0, h1 = tp.heads(tp.r)
    rep = tp.rep
    if h0 % rep == 0 and h1 % rep == 0:  # whole KV groups
        k, v = k[:, :, h0 // rep:h1 // rep], v[:, :, h0 // rep:h1 // rep]
    else:  # a group cut by the split: each query head's KV head
        idx = torch.arange(h0, h1, device=q.device) // rep
        k, v = k[:, :, idx], v[:, :, idx]
    if h1 == h0:
        b, s, _, hd = q.shape
        return q.new_zeros((b, s, 0))
    return _attend(q, k, v, tp.cfg, dtype)


def _out_proj(tp: _TP, att, wo_loc, have):
    """``att @ wo`` summed over ``model``: ``att``'s columns (rank r
    holds ``have(r)``) re-cut to ``wo``'s row blocks first."""
    n = tp.cfg.n_heads * tp.cfg.head_dim
    cols = spmd.regroup(att, -1, tp.mesh, tp.ax, have,
                        lambda r: tp.cols(n, r))
    return tp.psum(cols @ wo_loc)


def _ffn_sharded(tp: _TP, x, lp):
    cfg, shd = tp.cfg, tp.shd
    x = spmd.fan_out(x, tp.mesh, tp.ax)
    if cfg.moe is None:
        return tp.psum(_dense_ffn(x, lp, cfg))
    out = moe_lib.moe_apply(
        x, {"router": lp["router"], "w_gate": lp["moe_gate"],
            "w_up": lp["moe_up"], "w_down": lp["moe_down"]}, cfg.moe,
        mesh=tp.mesh, model_axis=tp.ax, fsdp_axis=shd.fsdp_axis(),
        fsdp_mode=shd.moe_fsdp_mode)
    if cfg.moe.dense_residual:
        out = out + tp.psum(_dense_ffn(x, lp, cfg))
    return out


def _cache_block(cfg, shd, mesh, shape):
    """(local cache shape, this rank's ``[s0, s1)`` of the sequence)."""
    bounds = SH.local_bounds(shape, cache_partition_specs(cfg, shd)["k"],
                             mesh)
    return tuple(hi - lo for lo, hi in bounds), bounds[3]


def _logits_out(tp: _TP, params: ShardedTransformer, x, batch: int):
    """Vocab-sharded logits ``[B, V]`` as a DTensor, from the final
    states ``x [b, D]`` of this rank's rows."""
    logits = params.out_norm(x) @ params.local_head()
    return SH.from_local(logits, (tp.shd.batch, tp.ax), tp.mesh,
                         (batch, tp.cfg.vocab_size))


def _prefill_sharded(params: ShardedTransformer, tokens, cfg, mesh, shd,
                     max_seq):
    tp = _TP(cfg, mesh, shd)
    tok = SH.local_input(tokens, (shd.batch, None), mesh)
    b, s = tok.shape
    full = (cfg.n_layers, tokens.shape[0], cfg.n_kv_heads, max_seq or s,
            cfg.head_dim)
    local_shape, (s0, s1) = _cache_block(cfg, shd, mesh, full)
    dt = SH.local(params.embed).dtype
    kc = torch.zeros(local_shape, dtype=dt, device=tok.device)
    vc = torch.zeros(local_shape, dtype=dt, device=tok.device)
    w1 = max(min(s1, s) - s0, 0)  # prompt slots this rank holds
    x = _embed_sharded(tp, SH.local(params.embed), tok)
    positions = _positions(b, s, tok.device)
    hd = cfg.head_dim

    def body(xc, lp):
        xn = L.norm(xc, lp.get("attn_norm"))
        q, k, v = _qkv_sharded(tp, xn, lp, positions, tp.heads)
        if w1:
            lp["k_cache"][:, :, :w1] = k[:, s0:s0 + w1].transpose(1, 2)
            lp["v_cache"][:, :, :w1] = v[:, s0:s0 + w1].transpose(1, 2)
        att = _attend_heads(tp, q, k, v, xc.dtype)
        xc = xc + _out_proj(tp, att, lp["wo"],
                            lambda r: tuple(i * hd for i in tp.heads(r)))
        return xc + _ffn_sharded(tp, L.norm(xc, lp.get("ffn_norm")), lp)

    x = scan_layers(body, x, {**params.local_layers(), "k_cache": kc,
                              "v_cache": vc})
    spec = cache_partition_specs(cfg, shd)["k"]
    cache = {"k": SH.from_local(kc, spec, mesh, full),
             "v": SH.from_local(vc, spec, mesh, full)}
    return _logits_out(tp, params, x[:, -1], tokens.shape[0]), cache


def _decode_attention(tp: _TP, q, kc, vc, pos, s0, dtype):
    """One token's attention ``[b, H·hd]`` (every head, the same on each
    rank of ``model``) over this rank's cache slots ``[s0, s0 + S_loc)``;
    with the sequence split, the softmax is combined over ``model``."""
    b, kv, rep, hd = q.shape
    s_loc = kc.shape[2]
    scores = torch.einsum("bkrh,bksh->bkrs", q, kc).to(F32).div_(hd ** 0.5)
    valid = (torch.arange(s_loc, device=q.device) + s0) <= pos
    if not tp.shd.shard_cache_seq:
        probs = _softmax_probs(scores, valid, dtype)
        return torch.einsum("bkrs,bksh->bkrh", probs, vc).reshape(b, -1)
    scores = scores.masked_fill_(~valid, MASK_VALUE)
    top = (scores.amax(-1, keepdim=True) if s_loc else
           scores.new_full((b, kv, rep, 1), MASK_VALUE))
    top = spmd.psum(top, tp.mesh, tp.ax, op="max")
    e = torch.exp(scores - top)
    den = tp.psum(e.sum(-1, keepdim=True))
    probs = (e / den).to(dtype)
    out = torch.einsum("bkrs,bksh->bkrh", probs, vc)
    return tp.psum(out).reshape(b, -1)


def _decode_sharded(params: ShardedTransformer, cache, token, pos, cfg,
                    mesh, shd):
    tp = _TP(cfg, mesh, shd)
    full = tuple(cache["k"].shape)
    _, (s0, _) = _cache_block(cfg, shd, mesh, full)
    spec = cache_partition_specs(cfg, shd)["k"]
    kc = SH.local_input(cache["k"], spec, mesh)
    vc = SH.local_input(cache["v"], spec, mesh)
    tok = SH.local_input(token, (shd.batch,), mesh)
    b = tok.shape[0]
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    every = lambda r: (0, h)  # noqa: E731
    x = _embed_sharded(tp, SH.local(params.embed), tok)
    posb = torch.full((b, 1), pos, device=tok.device)

    def body(xc, lp):
        xn = L.norm(xc, lp.get("attn_norm"))[:, None, :]
        q, k_new, v_new = _qkv_sharded(tp, xn, lp, posb, every)
        slot = pos - s0
        if 0 <= slot < lp["k_cache"].shape[2]:
            lp["k_cache"].narrow(2, slot, 1).copy_(k_new.transpose(1, 2))
            lp["v_cache"].narrow(2, slot, 1).copy_(v_new.transpose(1, 2))
        att = _decode_attention(tp, q.reshape(b, kv, h // kv, hd),
                                lp["k_cache"], lp["v_cache"], pos, s0,
                                xc.dtype)
        xc = xc + _out_proj(tp, att, lp["wo"], lambda r: (0, h * hd))
        return xc + _ffn_sharded(tp, L.norm(xc, lp.get("ffn_norm"))[:, None],
                                 lp)[:, 0]

    x = scan_layers(body, x, {**params.local_layers(), "k_cache": kc,
                              "v_cache": vc})
    return _logits_out(tp, params, x, token.shape[0]), cache


def vocab_block(cfg: TransformerConfig, mesh, shd: SH.LMSharding):
    """``[v0, v1)``: the vocabulary columns this rank's logits hold."""
    return SH.chunk_bounds(cfg.vocab_size, spmd.axis_size(
        mesh, shd.model_axis), spmd.axis_index(mesh, shd.model_axis))


def _logits_train_sharded(params: ShardedTransformer, tokens, cfg, mesh,
                          shd):
    tp = _TP(cfg, mesh, shd)
    tok = SH.local_input(tokens, (shd.batch, None), mesh)
    b, s = tok.shape
    x = _embed_sharded(tp, params.embed, tok)
    positions = _positions(b, s, tok.device)
    hd = cfg.head_dim

    def body(xc, lp):
        xn = L.norm(xc, lp.get("attn_norm"))
        q, k, v = _qkv_sharded(tp, xn, lp, positions, tp.heads)
        att = _attend_heads(tp, q, k, v, xc.dtype)
        xc = xc + _out_proj(tp, att, lp["wo"],
                            lambda r: tuple(i * hd for i in tp.heads(r)))
        return xc + _ffn_sharded(tp, L.norm(xc, lp.get("ffn_norm")), lp)

    x = scan_layers(body, x, params.local_layers(), cfg.remat)
    x = spmd.fan_out(params.out_norm(x), mesh, tp.ax)
    return x @ params.local_head()


def gold_rank_block(loc, gold, v0: int, mesh, axis: str):
    """``core.sorting.gold_rank`` of the logits whose vocabulary columns
    ``[v0, v0 + V_loc)`` this rank holds (``loc [..., V_loc]``) for its
    rows' ``gold [...]``: the gold logit summed over ``axis`` from the
    rank that holds it, each rank's count of the logits above it, the
    counts summed over ``axis``; int32 ``[...]``."""
    g = gold.long()
    mine = (g >= v0) & (g < v0 + loc.shape[-1])
    at = torch.where(mine, g - v0, torch.zeros_like(g))[..., None]
    gold_score = spmd.psum(torch.where(mine[..., None], torch.gather(
        loc, -1, at), torch.zeros_like(loc[..., :1])), mesh, axis)
    index = torch.arange(loc.shape[-1], device=loc.device) + v0
    above = (loc > gold_score) | ((loc == gold_score) & (index < g[..., None]))
    count = spmd.psum(torch.sum(above, dim=-1, dtype=torch.int32), mesh,
                      axis)
    return count + 1


def gold_rank_sharded(logits, gold, mesh, shd: SH.LMSharding):
    """``core.sorting.gold_rank`` of vocab-sharded ``logits`` (a DTensor
    ``[B, V]``, ``(batch, model)``): the gold logit summed over ``model``
    from the rank that holds it, each rank's count of the logits above
    it, the counts summed over ``model``; int32 ``[B]`` for every row,
    gathered over the data axes."""
    loc = SH.local(logits)
    g = SH.local_input(gold, (shd.batch,), mesh)
    v0 = SH.local_bounds(logits.shape, (shd.batch, shd.model_axis),
                         mesh)[1][0]
    return spmd.all_gather(gold_rank_block(loc, g, v0, mesh,
                                           shd.model_axis),
                           0, mesh, shd.data_axes)
