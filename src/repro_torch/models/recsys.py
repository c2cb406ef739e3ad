"""RecSys architectures: SASRec, xDeepFM (CIN), MIND (capsules), AutoInt.

The counterpart of ``repro.models.recsys``: scoring and the training
losses.  Shared anatomy: sparse embedding tables (the hot path, see
``embedding.py``) → feature-interaction op → small MLP → logit(s).

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

Training: ``sasrec_loss``, ``mind_loss`` and ``ctr_loss`` are the JAX
losses on a whole batch.  :func:`loss_and_grad` is what the ``train``
step runs: the same batch-mean loss and its gradient, with the sparse
front end (every table lookup, B3 among them) run and differentiated once
for the batch and the dense part in row chunks of at most
:data:`TRAIN_CHUNK_BYTES` of saved activations (:data:`TRAIN_PARTS`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn import Parameter as P

from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.models import embedding as E
from repro_torch.models import layers as L

#: the most bytes of per-row intermediates one chunk of a batch may hold
CHUNK_BYTES = 4 << 30
#: the same for a training chunk, whose activations backward keeps
TRAIN_CHUNK_BYTES = 8 << 30
#: a training row keeps about this many times a scoring row's
#: intermediates (the saved activations and their gradients)
TRAIN_ROW_FACTOR = 3
_F32_BYTES = 4


def rows_of(table, ids):
    """``table[ids]`` as one ``index_select`` (its backward is an
    ``index_add_``, which needs no host sync); the vocab-parallel lookup
    of an ``E.VocabParallel`` table."""
    if isinstance(table, E.VocabParallel):
        return table.lookup(ids.reshape(-1, 1)).reshape(*ids.shape,
                                                        table.dim)
    return torch.index_select(table, 0, ids.reshape(-1).long()).reshape(
        *ids.shape, table.shape[1])


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


class TableView:
    """A recsys model whose embedding tables are :class:`E.VocabParallel`
    blocks on a mesh (every other parameter is the model's own,
    replicated); the scoring functions take it in place of the model."""

    def __init__(self, model: nn.Module, tables: Dict[str, object]):
        self._model = model
        self.__dict__.update(tables)

    def __getattr__(self, name):
        return getattr(self.__dict__["_model"], name)


#: the tables JAX's recsys steps row-shard over `model`, by arch
SHARDED_TABLES = {"sasrec": ("item_emb",), "mind": ("item_emb",),
                  "xdeepfm": ("table", "linear"), "autoint": ("table",)}


def shard_tables(model: nn.Module, kind: str, mesh, axis: str = "model",
                 blocks: bool = False, local=None) -> TableView:
    """``model`` with its tables row-sharded over ``axis`` (each rank
    keeps a view of its block; nothing is copied).  ``blocks``: each
    rank's lookups are its own block of a list split over ``axis`` (see
    ``E.VocabParallel``).  ``local``: ``{name: block}``, the trainable
    blocks to use in place of views (a ``sharding.ShardedParams``; the
    model's own tables may then be ``meta``: only their shapes are
    read)."""
    tables = {}
    for name in SHARDED_TABLES[kind]:
        t = getattr(model, name)
        block = None if local is None else local[name]
        if t.dim() == 1:
            t = t[:, None]
            block = None if block is None else block[:, None]
        tables[name] = E.VocabParallel(t, mesh, axis, blocks, block)
    return TableView(model, tables)


def table_specs(model: nn.Module, kind: str, axis: str = "model"):
    """JAX's parameter specs of a sharded recsys step: each table of
    :data:`SHARDED_TABLES` split by rows over ``axis``, the rest
    replicated."""
    return {n: ((axis,) + (None,) * (p.dim() - 1)
                if n in SHARDED_TABLES[kind] else ())
            for n, p in model.named_parameters()}


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
    (causal)."""
    return _sasrec_blocks(params, rows_of(params.item_emb, item_ids), cfg)


def _sasrec_blocks(params: SASRec, x, cfg: SASRecConfig):
    """Item embeddings ``[B, S, D]`` → sequence representations.  The JAX
    package's ``scan`` over stacked blocks is a loop."""
    b, s, _ = x.shape
    d = cfg.embed_dim
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


def _candidate_rows(params, batch):
    """The candidates' item rows: ``batch["candidate_rows"]`` when the
    caller looked them up (a sharded step), else the rows of
    ``batch["candidates"]``, else the whole table."""
    if "candidate_rows" in batch:
        return batch["candidate_rows"]
    if "candidates" in batch:
        return rows_of(params.item_emb, batch["candidates"])
    return params.item_emb


def sasrec_retrieval_scores(params: SASRec, batch, cfg: SASRecConfig):
    """Last-position user state vs candidate item set → ``[B, n_cand]``."""
    h = sasrec_last_state(params, batch["items"], cfg)  # [B, D]
    return h @ _candidate_rows(params, batch).T


def _sasrec_front(params: SASRec, batch, cfg: SASRecConfig):
    return {k: rows_of(params.item_emb, batch[k])
            for k in ("items", "pos", "neg")}


def _sasrec_loss_sum(params: SASRec, emb, batch, cfg: SASRecConfig):
    """Σ over valid positions of the BCE of (next item, sampled
    negative), from the front end's embeddings."""
    h = _sasrec_blocks(params, emb["items"], cfg)  # [B, S, D]
    pos_logit = torch.sum(h * emb["pos"], -1)
    neg_logit = torch.sum(h * emb["neg"], -1)
    m = batch["mask"].to(torch.float32)
    loss = -(F.logsigmoid(pos_logit) + F.logsigmoid(-neg_logit))
    return torch.sum(loss * m)


def _sasrec_denominator(batch):
    return torch.clamp(torch.sum(batch["mask"].to(torch.float32)), min=1.0)


def sasrec_loss(params: SASRec, batch, cfg: SASRecConfig):
    """BCE over (positive next item, sampled negative) — the paper's
    loss, the mean over valid positions."""
    return (_sasrec_loss_sum(params, _sasrec_front(params, batch, cfg),
                             batch, cfg) / _sasrec_denominator(batch))


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


def _xdeepfm_row_bytes(cfg: CTRConfig) -> int:
    t = cfg.table
    widest = max((t.n_fields,) + tuple(cfg.cin_layers))
    return _F32_BYTES * t.n_fields * t.dim * widest * 2


def xdeepfm_score(params: XDeepFM, batch, cfg: CTRConfig):
    """pCTR logits ``[B]``.  The sparse front end runs once for the whole
    batch (one EmbeddingBag call per multi-hot field); the CIN and MLP run
    in row chunks (the CIN outer product is ``max(H)·F·D`` floats a row)."""
    emb = _sparse_features(params, batch, cfg)  # [B, F, D]
    dense = _by_rows(lambda bb: _xdeepfm_dense(params, bb["emb"]),
                     {"emb": emb}, _xdeepfm_row_bytes(cfg))
    return dense + _xdeepfm_linear(params, batch["ids"], cfg) + params.bias


def _xdeepfm_linear(params: XDeepFM, ids, cfg: CTRConfig):
    """The linear term ``[B]``: each field's weight, summed over fields."""
    t = cfg.table
    offsets = torch.arange(t.n_fields, dtype=ids.dtype,
                           device=ids.device) * t.vocab_per_field
    if isinstance(params.linear, E.VocabParallel):  # one bag a row
        return params.linear.lookup(ids + offsets[None])[:, 0]
    rows = (ids + offsets[None]).reshape(-1)
    return torch.sum(
        torch.index_select(params.linear, 0, rows).reshape(ids.shape), -1)


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


def _autoint_row_bytes(cfg: CTRConfig) -> int:
    f, width = cfg.table.n_fields, cfg.n_attn_heads * cfg.d_attn
    return _F32_BYTES * f * (5 * width + 2 * cfg.n_attn_heads * f)


def autoint_score(params: AutoInt, batch, cfg: CTRConfig):
    """pCTR logits ``[B]``: the sparse front end once for the batch, the
    attention layers in row chunks (q, k, v, the residual and the attention
    weights live at once)."""
    x = _sparse_features(params, batch, cfg)  # [B, F, D]
    return _by_rows(lambda bb: _autoint_dense(params, bb["x"], cfg),
                    {"x": x}, _autoint_row_bytes(cfg))


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
    return _mind_caps(params, rows_of(params.item_emb, batch["hist"]),
                      batch["hist_mask"], cfg)


def _mind_caps(params: MIND, hist, hist_mask, cfg: CTRConfig):
    """History embeddings ``[B, T, D]`` → interest capsules."""
    mask = hist_mask.to(torch.float32)  # [B, T]
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
    user = {"hist": batch["hist"], "hist_mask": batch["hist_mask"]}
    return _by_rows(lambda bb: _mind_rows(params, bb, cfg), user,
                    _mind_row_bytes(cfg))


def _mind_row_bytes(cfg: CTRConfig) -> int:
    t, d, k = cfg.hist_len, cfg.table.dim, cfg.n_interests
    return _F32_BYTES * (3 * t * d + 4 * k * t + 6 * k * d)


def _mind_front(params: MIND, batch, cfg: CTRConfig):
    return {k: rows_of(params.item_emb, batch[k])
            for k in ("hist", "pos", "negs")}


def _mind_loss_sum(params: MIND, emb, batch, cfg: CTRConfig):
    """Σ over rows of the sampled-softmax NLL of the positive item, with
    label-aware attention (the interest most aligned with the label)."""
    caps = _mind_caps(params, emb["hist"], batch["hist_mask"], cfg)
    pos, negs = emb["pos"], emb["negs"]  # [B, D], [B, Nneg, D]
    att = torch.einsum("bkd,bd->bk", caps, pos)
    pick = torch.argmax(att, -1)[:, None, None].expand(-1, 1, caps.shape[-1])
    best = torch.gather(caps, 1, pick)[:, 0]
    pos_logit = torch.sum(best * pos, -1, keepdim=True)
    neg_logit = torch.einsum("bd,bnd->bn", best, negs)
    logits = torch.cat([pos_logit, neg_logit], -1).to(torch.float32)
    return torch.sum(torch.logsumexp(logits, -1) - logits[:, 0])


def _batch_rows(batch):
    """The batch's row count as a float32 0-d tensor on its device."""
    x = next(iter(batch.values()))
    return torch.full((), float(x.shape[0]), dtype=torch.float32,
                      device=x.device)


def mind_loss(params: MIND, batch, cfg: CTRConfig):
    """Sampled softmax with label-aware attention (hard max at train):
    cross-entropy of the positive among it and the negatives, the mean
    over rows."""
    return (_mind_loss_sum(params, _mind_front(params, batch, cfg), batch,
                           cfg) / _batch_rows(batch))


def mind_retrieval_scores(params: MIND, batch, cfg: CTRConfig):
    """max over interests of ⟨candidate, interest⟩ → ``[B, n_cand]``."""
    caps = mind_interests(params, batch, cfg)
    scores = torch.einsum("bkd,nd->bkn", caps,
                          _candidate_rows(params, batch))
    return torch.max(scores, dim=1).values


# ===========================================================================
# Shared CTR loss
# ===========================================================================


def _bce_with_logits(logits, labels):
    lf = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.clamp(lf, min=0) - lf * y + torch.log1p(torch.exp(-lf.abs()))


def ctr_loss(score_fn, params, batch, cfg: CTRConfig):
    """Mean binary cross-entropy of the pCTR logits; returns
    ``(loss, logits)``."""
    logits = score_fn(params, batch, cfg)
    return torch.mean(_bce_with_logits(logits, batch["labels"])), logits


def _ctr_front(params, batch, cfg: CTRConfig):
    return {"emb": _sparse_features(params, batch, cfg)}  # [B, F, D]


def _xdeepfm_front(params: XDeepFM, batch, cfg: CTRConfig):
    return {**_ctr_front(params, batch, cfg),
            "lin": _xdeepfm_linear(params, batch["ids"], cfg)}


def _xdeepfm_loss_sum(params: XDeepFM, emb, batch, cfg: CTRConfig):
    logits = _xdeepfm_dense(params, emb["emb"]) + emb["lin"] + params.bias
    return torch.sum(_bce_with_logits(logits, batch["labels"]))


def _autoint_loss_sum(params: AutoInt, emb, batch, cfg: CTRConfig):
    logits = _autoint_dense(params, emb["emb"], cfg)
    return torch.sum(_bce_with_logits(logits, batch["labels"]))


# ===========================================================================
# Training: the sparse front end once, the dense part in row chunks
# ===========================================================================


@dataclasses.dataclass(frozen=True)
class TrainParts:
    """A recsys loss split where :func:`loss_and_grad` cuts it.

    * ``front(params, batch, cfg)`` → ``{name: [B, ...]}``: every table
      lookup of the batch (recorded for autograd);
    * ``loss_sum(params, emb, batch, cfg)``: the sum of the rows' loss
      terms, given the front end's outputs for those rows;
    * ``denominator(batch)``: the batch mean's divisor (0-d);
    * ``row_bytes(cfg)``: a scoring row's intermediates, in bytes.
    """

    front: Callable
    loss_sum: Callable
    denominator: Callable
    row_bytes: Callable


TRAIN_PARTS = {
    "sasrec": TrainParts(_sasrec_front, _sasrec_loss_sum, _sasrec_denominator,
                         _sasrec_row_bytes),
    "mind": TrainParts(_mind_front, _mind_loss_sum, _batch_rows,
                       _mind_row_bytes),
    "xdeepfm": TrainParts(_xdeepfm_front, _xdeepfm_loss_sum, _batch_rows,
                          _xdeepfm_row_bytes),
    "autoint": TrainParts(_ctr_front, _autoint_loss_sum, _batch_rows,
                          _autoint_row_bytes),
}


def train_chunk_rows(kind: str, cfg) -> int:
    """Rows of one training chunk of ``kind``: at most
    :data:`TRAIN_CHUNK_BYTES` of saved activations (TRAIN_ROW_FACTOR
    times a scoring row's intermediates), at least one row."""
    row = TRAIN_ROW_FACTOR * TRAIN_PARTS[kind].row_bytes(cfg)
    return max(1, TRAIN_CHUNK_BYTES // max(1, row))


def loss_and_grad(kind: str, params: nn.Module, batch, cfg,
                  rows: int | None = None, mesh=None,
                  data_axes=()) -> torch.Tensor:
    """The batch-mean training loss of ``kind`` (a detached 0-d tensor),
    its gradient added into every parameter's ``.grad``.

    The sparse front end runs once, its outputs are cut into row chunks
    of ``rows`` (default :func:`train_chunk_rows`), each chunk a leaf of
    its own; each chunk's dense part runs and backpropagates its share of
    the mean (its loss sum over the denominator), so only one chunk's
    activations live at a time; then the chunks' leaf gradients, put back
    together, backpropagate through the front end once (one B3 backward
    launch for every multi-hot field).  The gradient is JAX's
    ``value_and_grad`` of the batch mean, summed in another order.  No
    value is read back to the host.

    With ``mesh`` (a sharded train step): ``params`` is the model with
    its tables vocab-parallel (:func:`shard_tables`'s view of trainable
    blocks) and ``batch`` this rank's block of rows over ``data_axes``;
    the denominator and the returned loss are summed over them, so the
    loss is the global batch's mean and each gradient this rank's share
    of it (the step sums the replicated ones over ``data_axes``).
    """
    parts = TRAIN_PARTS[kind]
    n = next(iter(batch.values())).shape[0]
    rows = train_chunk_rows(kind, cfg) if rows is None else rows
    with torch.enable_grad():
        front = parts.front(params, batch, cfg)
        denom = parts.denominator(batch)
        if mesh is not None:
            denom = spmd.psum(denom, mesh, data_axes)
        leaf_grads = {k: [] for k in front}
        loss = torch.zeros((), dtype=torch.float32, device=denom.device)
        for s in range(0, n, rows):
            leaves = {k: v[s:s + rows].detach().requires_grad_()
                      for k, v in front.items()}
            sub = {k: v[s:s + rows] for k, v in batch.items()}
            part = parts.loss_sum(params, leaves, sub, cfg) / denom
            part.backward()
            loss = loss + part.detach()
            for k, v in leaves.items():
                leaf_grads[k].append(v.grad)
            del leaves, part
        torch.autograd.backward(
            list(front.values()),
            [torch.cat(leaf_grads.pop(k)) for k in list(front)])
    return loss if mesh is None else spmd.psum(loss, mesh, data_axes)
