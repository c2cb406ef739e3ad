"""RecSys architectures: SASRec, xDeepFM (CIN), MIND (capsules), AutoInt.

The counterpart of ``repro.models.recsys``, serving only (training waits
for the optimizer).  Shared anatomy: sparse embedding tables (the hot path,
see ``embedding.py``) → feature-interaction op → small MLP → logit(s).

Each model is an ``nn.Module`` built from its config on an explicit device
with a ``torch.Generator``; its parameter names and layouts follow the JAX
pytree (``table``, ``cin.<i>``, ``mlp_w.<i>``, ``blocks.wqkv``, ...), dense
weights stay ``[d_in, d_out]`` and are applied as ``x @ w``.  The scoring
functions take the module in the JAX functions' ``params`` slot:

  * ``xdeepfm_score`` / ``autoint_score``        → pCTR logits ``[B]``;
  * ``sasrec_encode`` / ``mind_interests``        → user states;
  * ``sasrec_retrieval_scores`` / ``mind_retrieval_scores`` →
    ``[B, n_cand]``.

The dense part of a score (CIN, attention, transformer blocks, capsules)
runs over the batch axis in chunks of at most :data:`CHUNK_BYTES` of
intermediates, so ``serve_bulk`` (262,144 rows) and CTR ``retrieval_cand``
(10⁶ candidate rows) fit on one card; the sparse front end runs once per
call.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn
from torch.nn import Parameter as P

from repro_torch.device import resolve_device
from repro_torch.models import embedding as E
from repro_torch.models import layers as L

#: the most bytes of per-row intermediates one chunk of a batch may hold
CHUNK_BYTES = 4 << 30
_F32_BYTES = 4


def _setup(device, generator):
    """(device, generator): CUDA by default; a generator seeded 0 on that
    device unless one is given; none on ``meta`` (shapes only)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return dev, None
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, generator


def _by_rows(fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
             batch: Dict[str, torch.Tensor], row_bytes: int) -> torch.Tensor:
    """``fn`` over the batch's leading axis in chunks of at most
    ``CHUNK_BYTES // row_bytes`` rows, results concatenated.  Rows are
    independent, so each row's value is what one call would give it, up to
    the summation order a matrix product picks for another shape."""
    n = next(iter(batch.values())).shape[0]
    rows = max(1, CHUNK_BYTES // max(1, row_bytes))
    if n <= rows:
        return fn(batch)
    return torch.cat([fn({k: v[s:s + rows] for k, v in batch.items()})
                      for s in range(0, n, rows)], 0)


# ===========================================================================
# SASRec — self-attentive sequential recommendation (arXiv:1808.09781)
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str
    n_items: int
    embed_dim: int
    n_blocks: int
    n_heads: int
    seq_len: int
    dtype: str = "float32"

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


class SASRec(nn.Module):
    """Parameters: ``item_emb`` ``[n_items, D]``, ``pos_emb`` ``[S, D]`` and
    ``blocks.{wqkv, wo, w1, w2}`` stacked over blocks ``[n_blocks, ...]``."""

    def __init__(self, cfg: SASRecConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev, gen = _setup(device, generator)
        d, nb, dt = cfg.embed_dim, cfg.n_blocks, cfg.torch_dtype

        def normal(shape, scale):
            return P(L.normal(gen, shape, scale, dt, dev))

        self.item_emb = normal((cfg.n_items, d), 0.02)
        self.pos_emb = normal((cfg.seq_len, d), 0.02)
        fan = (1.0 / d) ** 0.5
        self.blocks = nn.ParameterDict({
            "wqkv": normal((nb, d, 3 * d), fan),
            "wo": normal((nb, d, d), fan),
            "w1": normal((nb, d, d), fan),
            "w2": normal((nb, d, d), fan),
        })


def _sasrec_row_bytes(cfg: SASRecConfig) -> int:
    s, d = cfg.seq_len, cfg.embed_dim
    return _F32_BYTES * s * (8 * d + 2 * cfg.n_heads * s)


def sasrec_encode(params: SASRec, item_ids, cfg: SASRecConfig):
    """item_ids ``[B, S]`` → sequence representations ``[B, S, D]``
    (causal).  The JAX package's ``scan`` over stacked blocks is a loop."""
    b, s = item_ids.shape
    d = cfg.embed_dim
    x = params.item_emb[item_ids.long()]
    x = x + params.pos_emb[None, :s]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=x.device))
    hd = d // cfg.n_heads
    blocks = params.blocks
    for i in range(cfg.n_blocks):
        qkv = L.nonparam_layernorm(x) @ blocks["wqkv"][i]
        q, k, v = (t.reshape(b, s, cfg.n_heads, hd)
                   for t in torch.split(qkv, d, dim=-1))
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
        sc = sc / hd**0.5
        sc = torch.where(causal[None, None], sc, -1e30)
        p = torch.softmax(sc, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d)
        x = x + o @ blocks["wo"][i]
        h = torch.relu(L.nonparam_layernorm(x) @ blocks["w1"][i]) \
            @ blocks["w2"][i]
        x = x + h
    return L.nonparam_layernorm(x)


def sasrec_last_state(params: SASRec, item_ids, cfg: SASRecConfig):
    """The last position's state ``[B, D]``, in row chunks."""
    return _by_rows(lambda bb: sasrec_encode(params, bb["items"], cfg)[:, -1],
                    {"items": item_ids}, _sasrec_row_bytes(cfg))


def sasrec_retrieval_scores(params: SASRec, batch, cfg: SASRecConfig):
    """Last-position user state vs candidate item set → ``[B, n_cand]``."""
    h = sasrec_last_state(params, batch["items"], cfg)  # [B, D]
    cand = params.item_emb
    if "candidates" in batch:
        cand = params.item_emb[batch["candidates"].long()]
    return h @ cand.T


# ===========================================================================
# CTR models: shared sparse-feature front end
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class CTRConfig:
    name: str
    table: E.TableConfig
    # xDeepFM
    cin_layers: tuple = ()
    mlp_dims: tuple = ()
    # AutoInt
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # MIND
    n_interests: int = 0
    capsule_iters: int = 0
    hist_len: int = 0
    n_multi_hot: int = 0  # leading fields that are multi-hot (bags)
    multi_hot_len: int = 8
    dtype: str = "float32"

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


def _sparse_features(params, batch, cfg: CTRConfig):
    """ids ``[B, F]`` (+ optional multi-hot bags) → field embeddings
    ``[B, F, D]``.  All multi-hot fields are one EmbeddingBag call."""
    tab = params.table
    emb = E.field_lookup(tab, batch["ids"], cfg.table)  # [B, F, D]
    if cfg.n_multi_hot and "mh_ids" in batch:
        # First n_multi_hot fields also receive a bag of extra values.
        emb[:, :cfg.n_multi_hot] += E.multi_hot_lookup_all(
            tab, batch["mh_ids"][:, :cfg.n_multi_hot],
            batch["mh_mask"][:, :cfg.n_multi_hot], cfg.table)
    return emb


def _mlp(x, ws, bs):
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w + b
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


# ===========================================================================
# xDeepFM — Compressed Interaction Network (arXiv:1803.05170)
# ===========================================================================


class XDeepFM(nn.Module):
    """Parameters: ``table``, ``linear`` ``[Σ vocab]``, ``cin.<i>``
    ``[H_i, H_{i-1}, F]``, ``cin_out``, ``mlp_w.<i>``, ``mlp_b.<i>``,
    ``bias`` (a scalar)."""

    def __init__(self, cfg: CTRConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev, gen = _setup(device, generator)
        dt = cfg.torch_dtype
        d, f = cfg.table.dim, cfg.table.n_fields
        self.table = P(E.init_table(gen, cfg.table, dt, device=dev))
        self.linear = P(L.normal(gen, (cfg.table.total_rows,), 0.01, dt, dev))
        cin, h_prev = [], f
        for h in cfg.cin_layers:
            cin.append(P(L.normal(gen, (h, h_prev, f),
                                  (1.0 / (h_prev * f)) ** 0.5, dt, dev)))
            h_prev = h
        self.cin = nn.ParameterList(cin)
        dims = (f * d,) + tuple(cfg.mlp_dims) + (1,)
        self.mlp_w = nn.ParameterList(
            [P(L.dense_init(gen, a, b, dt, device=dev))
             for a, b in zip(dims[:-1], dims[1:])])
        self.mlp_b = nn.ParameterList(
            [P(torch.zeros((b,), dtype=dt, device=dev)) for b in dims[1:]])
        self.cin_out = P(L.dense_init(gen, sum(cfg.cin_layers), 1, dt,
                                      device=dev))
        self.bias = P(torch.zeros((), dtype=dt, device=dev))


def _cin(x0, ws):
    """Compressed Interaction Network, sum-pooled: ``[B, F, D]`` →
    ``[B, ΣH]``.  Layer k, ``x^{k+1}_p = Σ_{h,m} W_p[h,m] x^k_h ∘ x^0_m``,
    is written as the outer product laid out ``[H·F, B·D]`` and ONE matrix
    product with ``W.reshape(P, H·F)`` (not B products of width D)."""
    b, f, d = x0.shape
    x0_t = x0.permute(1, 0, 2)  # [F, B, D]
    xk_t = x0_t
    pooled = []
    for w in ws:
        p, h, _ = w.shape
        z = (xk_t[:, None] * x0_t[None]).reshape(h * f, b * d)
        xk_t = (w.reshape(p, h * f) @ z).reshape(p, b, d)
        pooled.append(torch.sum(xk_t, dim=-1).T)  # sum-pool over D → [B, P]
    return torch.cat(pooled, dim=-1)


def _xdeepfm_dense(params: XDeepFM, emb):
    """CIN + deep logits of field embeddings ``[B, F, D]`` → ``[B]``."""
    b, f, d = emb.shape
    cin_logit = _cin(emb, params.cin) @ params.cin_out
    deep_logit = _mlp(emb.reshape(b, f * d), params.mlp_w, params.mlp_b)
    return cin_logit[:, 0] + deep_logit[:, 0]


def xdeepfm_score(params: XDeepFM, batch, cfg: CTRConfig):
    """pCTR logits ``[B]``.  The sparse front end runs once for the whole
    batch (one EmbeddingBag call per multi-hot field); the CIN and MLP run
    in row chunks (the CIN outer product is ``max(H)·F·D`` floats a row)."""
    t = cfg.table
    emb = _sparse_features(params, batch, cfg)  # [B, F, D]
    widest = max((t.n_fields,) + tuple(cfg.cin_layers))
    row_bytes = _F32_BYTES * t.n_fields * t.dim * widest * 2
    dense = _by_rows(lambda bb: _xdeepfm_dense(params, bb["emb"]),
                     {"emb": emb}, row_bytes)
    ids = batch["ids"]
    offsets = torch.arange(t.n_fields, dtype=ids.dtype,
                           device=ids.device) * t.vocab_per_field
    rows = (ids + offsets[None]).reshape(-1)
    lin_logit = torch.sum(
        torch.index_select(params.linear, 0, rows).reshape(ids.shape), -1)
    return dense + lin_logit + params.bias


# ===========================================================================
# AutoInt — self-attentive feature interaction (arXiv:1810.11921)
# ===========================================================================


class AutoInt(nn.Module):
    """Parameters: ``table``, ``attn.<i>.{wq, wk, wv, wres}``, ``head``."""

    def __init__(self, cfg: CTRConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev, gen = _setup(device, generator)
        dt = cfg.torch_dtype
        da, nh = cfg.d_attn, cfg.n_attn_heads
        self.table = P(E.init_table(gen, cfg.table, dt, device=dev))
        attn, d_in = [], cfg.table.dim
        for _ in range(cfg.n_attn_layers):
            attn.append(nn.ParameterDict({
                name: P(L.dense_init(gen, d_in, da * nh, dt, device=dev))
                for name in ("wq", "wk", "wv", "wres")}))
            d_in = da * nh
        self.attn = nn.ModuleList(attn)
        self.head = P(L.dense_init(gen, cfg.table.n_fields * d_in, 1, dt,
                                   device=dev))


def _autoint_dense(params: AutoInt, x, cfg: CTRConfig):
    """Self-attention layers and head over field embeddings ``[B, F, D]``
    → ``[B]``."""
    b, f, _ = x.shape
    nh, da = cfg.n_attn_heads, cfg.d_attn
    for lp in params.attn:
        q = (x @ lp["wq"]).reshape(b, f, nh, da)
        k = (x @ lp["wk"]).reshape(b, f, nh, da)
        v = (x @ lp["wv"]).reshape(b, f, nh, da)
        sc = torch.einsum("bfhd,bghd->bhfg", q, k).to(torch.float32)
        sc = sc / da**0.5
        p = torch.softmax(sc, dim=-1).to(x.dtype)
        o = torch.einsum("bhfg,bghd->bfhd", p, v).reshape(b, f, nh * da)
        x = torch.relu(o + x @ lp["wres"])
    return (x.reshape(b, -1) @ params.head)[:, 0]


def autoint_score(params: AutoInt, batch, cfg: CTRConfig):
    """pCTR logits ``[B]``: the sparse front end once for the batch, the
    attention layers in row chunks (q, k, v, the residual and the attention
    weights live at once)."""
    f, width = cfg.table.n_fields, cfg.n_attn_heads * cfg.d_attn
    row_bytes = _F32_BYTES * f * (5 * width + 2 * cfg.n_attn_heads * f)
    x = _sparse_features(params, batch, cfg)  # [B, F, D]
    return _by_rows(lambda bb: _autoint_dense(params, bb["x"], cfg),
                    {"x": x}, row_bytes)


# ===========================================================================
# MIND — multi-interest capsule routing (arXiv:1904.08030)
# ===========================================================================


class MIND(nn.Module):
    """Parameters: ``item_emb``, ``bilinear``, ``proj1``, ``proj2``."""

    def __init__(self, cfg: CTRConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev, gen = _setup(device, generator)
        dt = cfg.torch_dtype
        d = cfg.table.dim
        self.item_emb = P(L.normal(gen, (cfg.table.vocab_per_field, d), 0.02,
                                   dt, dev))
        self.bilinear = P(L.dense_init(gen, d, d, dt, device=dev))
        self.proj1 = P(L.dense_init(gen, d, 4 * d, dt, device=dev))
        self.proj2 = P(L.dense_init(gen, 4 * d, d, dt, device=dev))


def _mind_rows(params: MIND, batch, cfg: CTRConfig):
    hist = params.item_emb[batch["hist"].long()]  # [B, T, D]
    mask = batch["hist_mask"].to(torch.float32)  # [B, T]
    b, t, d = hist.shape
    k = cfg.n_interests
    u = hist @ params.bilinear  # shared bilinear map S·e_i

    logits = torch.zeros((b, k, t), dtype=torch.float32, device=hist.device)
    caps = torch.zeros((b, k, d), dtype=hist.dtype, device=hist.device)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(logits, dim=1) * mask[:, None, :]
        s = torch.einsum("bkt,btd->bkd", w.to(hist.dtype), u)
        # squash
        nrm2 = torch.sum(torch.square(s.to(torch.float32)), -1, keepdim=True)
        caps = s * (nrm2 / (1 + nrm2) / torch.sqrt(nrm2 + 1e-9)).to(s.dtype)
        logits = logits + torch.einsum("bkd,btd->bkt", caps, u).to(
            torch.float32)
    # per-interest MLP (H-layer)
    return torch.relu(caps @ params.proj1) @ params.proj2  # [B, K, D]


def mind_interests(params: MIND, batch, cfg: CTRConfig):
    """Behavior sequence → K interest capsules ``[B, K, D]`` via B2I
    dynamic routing, in row chunks."""
    t, d, k = cfg.hist_len, cfg.table.dim, cfg.n_interests
    row_bytes = _F32_BYTES * (3 * t * d + 4 * k * t + 6 * k * d)
    user = {"hist": batch["hist"], "hist_mask": batch["hist_mask"]}
    return _by_rows(lambda bb: _mind_rows(params, bb, cfg), user, row_bytes)


def mind_retrieval_scores(params: MIND, batch, cfg: CTRConfig):
    """max over interests of ⟨candidate, interest⟩ → ``[B, n_cand]``."""
    caps = mind_interests(params, batch, cfg)
    cand = params.item_emb
    if "candidates" in batch:
        cand = params.item_emb[batch["candidates"].long()]
    scores = torch.einsum("bkd,nd->bkn", caps, cand)
    return torch.max(scores, dim=1).values
