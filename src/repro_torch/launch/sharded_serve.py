"""Self-check of model-parallel serving over a process group: each rank
runs the sharded steps (``launch.steps`` with a mesh) and the same steps
without a mesh on the same weights and inputs, and saves both.

Run one process per rank (or under ``torchrun``)::

    python -m repro_torch.launch.sharded_serve --store /tmp/g --rank R \\
        --world-size 4 --mesh 2x2 --device cpu --size smoke --out DIR
    python -m repro_torch.launch.sharded_serve --store /tmp/g --rank R \\
        --world-size 2 --mesh 1x2 --device cuda:0 --backend gloo \\
        --size card --cases lm:olmo-1b,retrieval:sasrec,serve:xdeepfm

Cases (``--cases``, comma-separated):

* ``lm:<arch>`` — ``prefill`` of a seeded prompt into a cache with
  ``DECODE_STEPS`` free slots, then that many ``decode`` steps (the cache
  sequence-sharded over ``model``); against the unsharded steps run on
  each data shard's rows (MoE capacity comes from a shard's tokens, as in
  JAX), the decode on the whole batch;
* ``moe:<arch>`` — the MoE block of the arch alone on seeded tokens, in
  FSDP ``gather`` and ``activation`` modes;
* ``lookup`` — xDeepFM's vocab-parallel field and multi-hot lookups
  (``sum`` and ``mean``) against the unsharded lookups;
* ``retrieval:<arch>`` — ``retrieval_cand`` with the candidates split
  over ``model`` (in ``--size smoke``, seeded ties: repeated candidate
  ids; and NaN scores: NaN item rows);
* ``serve:<arch>`` — ``serve_bulk`` with the tables row-sharded;
* ``eval`` — the ``pytrec-eval`` arch's step on the mesh against its
  unsharded aggregates;
* ``gather`` — ``sharding.full_tensor`` of a tensor split unevenly.

``--size smoke`` uses the smoke configs at a few rows; ``card`` the full
widths chip_smoke's phase P runs (olmo-1b with 2 layers, a 1,024-token
prompt; SASRec's 10⁶ candidates; xDeepFM's 262,144 rows).  ``--weights
DIR`` loads ``DIR/<arch>.npz`` (a JAX parameter tree flattened with
``models.convert.flatten_params``) instead of seeded weights.  Each rank
writes ``DIR/rank<R>.npz`` (``<case>/got/...`` sharded, ``<case>/want/...``
unsharded, ``<case>/inputs/...``) and prints one JSON line: the kernel
launches of its sharded calls per case (B2: top-k, B3: EmbeddingBag, as
the C entry points count them; a retrieval case's B2 launches also split
into ``topk_block`` and ``topk_merge``) and each case's seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from datetime import timedelta
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT = timedelta(seconds=60)
DECODE_STEPS = 4
#: (prompt, batch per data shard, layers or None for the config's) by size
LM_SIZES = {"smoke": (8, 2, None), "card": (1024, 1, 2)}
RETRIEVAL_SIZES = {"smoke": (64, 32), "card": (None, None)}  # (n_cand, k)
SERVE_ROWS = {"smoke": 16, "card": None}
MOE_TOKENS = 12  # a data shard's tokens in the moe case


def _np(t) -> np.ndarray:
    from repro_torch.distributed.sharding import full_tensor

    t = full_tensor(t).detach().to("cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _launches():
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import topk as TK

    return {"topk": TK.KERNEL_LAUNCHES, "embedding_bag": EB.LAUNCHES}


def _zero_launches():
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import topk as TK

    TK.LAUNCHES = TK.KERNEL_LAUNCHES = EB.LAUNCHES = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Run:
    """One rank's cases: results by key, launches and seconds by case."""

    def __init__(self, mesh, device, size, seed, weights):
        self.mesh, self.device, self.size = mesh, device, size
        self.seed, self.weights = seed, weights
        self.out: Dict[str, np.ndarray] = {}
        self.launches: Dict[str, dict] = {}
        self.seconds: Dict[str, float] = {}
        from repro_torch.launch.mesh import data_axes_of
        from repro_torch.distributed import spmd

        self.n_data = spmd.axis_size(mesh, data_axes_of(mesh))

    def put(self, prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                self.put(f"{prefix}/{k}", v)
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                self.put(f"{prefix}/{i}", v)
        else:
            self.out[prefix] = _np(tree) if isinstance(
                tree, torch.Tensor) else np.asarray(tree)

    def sharded(self, case, fn):
        """``fn()`` with the kernel counts set to 0 before and read after
        (the sharded call's own launches)."""
        _sync(self.device)
        _zero_launches()
        t0 = time.perf_counter()
        out = fn()
        _sync(self.device)
        self.seconds[case] = time.perf_counter() - t0
        self.launches[case] = _launches()
        return out

    def model(self, tag, cfg, make):
        """The model on the device: JAX-carried weights from
        ``--weights``/``<tag>.npz`` when there, else seeded."""
        from repro_torch.models.convert import load_jax_params

        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        model = make(cfg, device=self.device, generator=gen)
        path = os.path.join(self.weights or "", f"{tag}.npz")
        if self.weights and os.path.exists(path):
            load_jax_params(model, dict(np.load(path)))
        return model


def lm_config(arg: str, size: str):
    """(arch name, config, weights tag) of ``<arch>[:field=int]...``: the
    arch's config at ``size`` with those fields replaced."""
    from repro_torch.launch.api import get_arch

    name, *fields = arg.split(":")
    cfg = get_arch(name).make_config(size == "smoke")
    over = {k: int(v) for k, v in (f.split("=") for f in fields)}
    if LM_SIZES[size][2] is not None:
        over.setdefault("n_layers", LM_SIZES[size][2])
    tag = arg.replace(":", "_").replace("=", "-")
    return name, dataclasses.replace(cfg, **over), tag


def lm_case(run: _Run, arg: str) -> None:
    """Prefill + DECODE_STEPS decodes, sharded against unsharded."""
    from repro_torch.configs.common import smoke_shape
    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.launch.api import get_arch
    from repro_torch.models import transformer as tfm

    name, cfg, tag = lm_config(arg, run.size)
    arch = get_arch(name)
    prompt, per_shard, _ = LM_SIZES[run.size]
    b = per_shard * run.n_data
    model = run.model(tag, cfg, tfm.Transformer)
    rng = np.random.default_rng(run.seed + 1)
    tokens = rng.integers(0, cfg.vocab_size, (b, prompt), dtype=np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (DECODE_STEPS + 1, b),
                       dtype=np.int32)
    dev = run.device
    tok = torch.from_numpy(tokens).to(dev)
    steps = [torch.from_numpy(x).to(dev) for x in nxt]
    max_seq = prompt + DECODE_STEPS
    pre = arch.shapes["prefill_32k"]
    dec = arch.shapes["decode_32k"]
    shape_p = smoke_shape(pre, seq_len=prompt, global_batch=b)
    shape_d = smoke_shape(dec, seq_len=max_seq, global_batch=b)
    key = f"lm:{arg}"
    run.put(f"{key}/inputs", {"tokens": tokens, "next": nxt})

    def sharded():
        bp = arch.make_step(cfg, shape_p, dev, run.mesh)
        bd = arch.make_step(cfg, shape_d, dev, run.mesh)
        logits, cache = bp.step_fn(model, tok, max_seq=max_seq)
        outs = {"prefill": logits}
        for t in range(DECODE_STEPS):
            logits, cache, metrics = bd.step_fn(
                model, cache, steps[t], prompt + t, steps[t + 1])
            outs[f"decode{t}"] = logits
            outs[f"metrics{t}"] = metrics
        outs["cache_k"], outs["cache_v"] = cache["k"], cache["v"]
        return outs

    got = run.sharded(key, sharded)
    bp = arch.make_step(cfg, shape_p, dev)
    bd = arch.make_step(cfg, shape_d, dev)
    # the unsharded prefill on each data shard's rows, then the whole batch
    parts = [bp.step_fn(model, tok[i * per_shard:(i + 1) * per_shard],
                        max_seq=max_seq) for i in range(run.n_data)]
    logits = torch.cat([p[0] for p in parts])
    cache = {k: torch.cat([p[1][k] for p in parts], 1) for k in ("k", "v")}
    want = {"prefill": logits}
    for t in range(DECODE_STEPS):
        logits, cache, metrics = bd.step_fn(model, cache, steps[t],
                                            prompt + t, steps[t + 1])
        want[f"decode{t}"] = logits
        want[f"metrics{t}"] = metrics
    want["cache_k"], want["cache_v"] = cache["k"], cache["v"]
    for k in ("cache_k", "cache_v"):  # on the card: compared, not saved
        w = (want.pop(k) if run.size == "card" else want[k]).float()
        g = got.pop(k) if run.size == "card" else got[k]
        diff = (full_tensor(g).float() - w).abs().max()
        run.put(f"{key}/{k}_max_abs_diff", float(diff))
        run.put(f"{key}/{k}_max_abs", float(w.abs().max()))
    run.put(f"{key}/got", got)
    run.put(f"{key}/want", want)


def moe_case(run: _Run, arg: str) -> None:
    """The arch's first MoE layer on seeded tokens ``[n_data ·
    MOE_TOKENS, D]``, FSDP over the last data axis, in both modes."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import data_axes_of
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm

    _, cfg, tag = lm_config(arg, run.size)
    model = run.model(tag, cfg, tfm.Transformer)
    data = data_axes_of(run.mesh)
    shd = SH.LMSharding(data_axes=data, fsdp_experts=True)
    rng = np.random.default_rng(run.seed + 2)
    x = rng.standard_normal((run.n_data * MOE_TOKENS, cfg.d_model)
                            ).astype(np.float32)
    key = f"moe:{arg}"
    run.put(f"{key}/inputs/x", x)
    lp = {k: v.detach()[0] for k, v in model.layers.items()}
    names = {"router": "router", "w_gate": "moe_gate", "w_up": "moe_up",
             "w_down": "moe_down"}
    specs = {"router": (), "w_gate": shd.p_expert_in(),
             "w_up": shd.p_expert_in(), "w_down": shd.p_expert_out()}
    full = {k: lp[v] for k, v in names.items()}
    local = {k: SH.local_shard(full[k], specs[k], run.mesh) for k in full}
    xt = torch.from_numpy(x).to(run.device).to(cfg.torch_dtype)
    xl = SH.local_shard(xt, (shd.batch, None), run.mesh)

    def sharded():
        out = {}
        for mode in ("gather", "activation"):
            y = moe_lib.moe_apply(xl, local, cfg.moe, mesh=run.mesh,
                                  fsdp_axis=shd.fsdp_axis(), fsdp_mode=mode)
            out[mode] = SH.from_local(y, (shd.batch, None), run.mesh,
                                      xt.shape)
        return out

    with torch.inference_mode():
        got = run.sharded(key, sharded)
        per = [moe_lib.moe_apply(xt[i * MOE_TOKENS:(i + 1) * MOE_TOKENS],
                                 full, cfg.moe) for i in range(run.n_data)]
        want = {"gather": torch.cat(per),
                # activation mode routes the tokens gathered over the
                # FSDP axis, here every data rank's
                "activation": moe_lib.moe_apply(xt, full, cfg.moe)}
    run.put(f"{key}/got", got)
    run.put(f"{key}/want", want)


def lookup_case(run: _Run) -> None:
    """Vocab-parallel field and multi-hot lookups, ``sum`` and ``mean``."""
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.steps import MODELS
    from repro_torch.models import embedding as E

    cfg = get_arch("xdeepfm").make_config(True)
    model = run.model("xdeepfm", cfg, MODELS["xdeepfm"])
    batch = _ctr_batch(cfg, 16, run.seed + 3)
    run.put("lookup/inputs", {**batch, "table": model.table})
    b = to_device(batch, run.device)
    table = model.table.detach()
    vp = E.VocabParallel(table, run.mesh)
    mh = (b["mh_ids"][:, :cfg.n_multi_hot], b["mh_mask"][:, :cfg.n_multi_hot])

    def sharded():
        return {"field": E.field_lookup(vp, b["ids"], cfg.table),
                "sum": E.multi_hot_lookup_all(vp, *mh, cfg.table),
                "mean": E.multi_hot_lookup_all(vp, *mh, cfg.table, "mean")}

    with torch.inference_mode():
        got = run.sharded("lookup", sharded)
        want = {"field": E.field_lookup(table, b["ids"], cfg.table),
                "sum": E.multi_hot_lookup_all(table, *mh, cfg.table),
                "mean": E.multi_hot_lookup_all(table, *mh, cfg.table,
                                               "mean")}
    run.put("lookup/got", got)
    run.put("lookup/want", want)


@contextlib.contextmanager
def _merge_launches():
    """A list that gets the B2 launches of each ``steps.merge_topk`` call
    made while active, so that a case's B2 launches split into its
    candidate block's and its merge's."""
    from repro_torch.kernels import topk as TK
    from repro_torch.launch import steps

    merge, merged = steps.merge_topk, []

    def counted(*args):
        before = TK.KERNEL_LAUNCHES
        out = merge(*args)
        merged.append(TK.KERNEL_LAUNCHES - before)
        return out

    steps.merge_topk = counted
    try:
        yield merged
    finally:
        steps.merge_topk = merge


def retrieval_case(run: _Run, name: str) -> None:
    """``retrieval_cand`` with the candidates split over ``model``."""
    from repro_torch.configs.common import smoke_shape
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.steps import MODELS

    arch = get_arch(name)
    smoke = run.size == "smoke"
    cfg = arch.make_config(smoke)
    nc, k = RETRIEVAL_SIZES[run.size]
    shape = arch.shapes["retrieval_cand"]
    if smoke:
        shape = smoke_shape(shape, n_candidates=nc, topk=k)
    nc = shape.get("n_candidates")
    model = run.model(name, cfg, MODELS[name])
    rng = np.random.default_rng(run.seed + 4)
    n_items = (cfg.n_items if name == "sasrec"
               else cfg.table.vocab_per_field)
    cand = rng.integers(0, n_items, nc, dtype=np.int32)
    if smoke:
        # ties: repeated ids score alike; NaN scores: NaN item rows, for
        # so many candidates that the top k (a block's width) holds some
        cand[50:56] = cand[1:7]
        with torch.no_grad():
            model.item_emb[torch.from_numpy(cand[10:50]).long()] = \
                float("nan")
    batch = _user_batch(name, cfg, run.seed + 4)
    rel = (rng.random((1, nc)) < 0.01).astype(np.int32)
    run.put(f"retrieval:{name}/inputs", {"cand": cand, "rel": rel, **batch})
    dev = run.device
    args = (to_device(batch, dev), torch.from_numpy(cand).to(dev),
            torch.from_numpy(rel).to(dev))
    step = arch.make_step(cfg, shape, dev, run.mesh)
    with _merge_launches() as merged:
        got = run.sharded(f"retrieval:{name}",
                          lambda: step.step_fn(model, *args))
    counts = run.launches[f"retrieval:{name}"]
    counts["topk_merge"] = sum(merged)
    counts["topk_block"] = counts["topk"] - counts["topk_merge"]
    want = arch.make_step(cfg, shape, dev).step_fn(model, *args)
    run.put(f"retrieval:{name}/got", got)
    run.put(f"retrieval:{name}/want", want)


def _ctr_batch(cfg, rows, seed):
    from repro_torch.data import recsys_data as RD

    batch = RD.ctr_batch(RD.CTRDataConfig(
        cfg.table.n_fields, cfg.table.vocab_per_field, rows,
        cfg.n_multi_hot, cfg.multi_hot_len, seed), 0)
    batch.pop("labels", None)
    return batch


def _user_batch(name, cfg, seed):
    """One user's inputs from ``data.recsys_data`` (a CTR arch: its
    fields)."""
    from repro_torch.data import recsys_data as RD

    if name == "sasrec":
        return RD.seq_batch(RD.SeqDataConfig(cfg.n_items, cfg.seq_len, 1,
                                             seed=seed), 0)
    if name == "mind":
        return RD.mind_batch(RD.SeqDataConfig(
            cfg.table.vocab_per_field, cfg.hist_len, 1, seed=seed), 0)
    return {"ids": _ctr_batch(cfg, 1, seed)["ids"]}


def serve_case(run: _Run, name: str) -> None:
    """``serve_bulk`` with the tables row-sharded over ``model``."""
    from repro_torch.configs.common import smoke_shape
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.steps import MODELS

    arch = get_arch(name)
    smoke = run.size == "smoke"
    cfg = arch.make_config(smoke)
    shape = arch.shapes["serve_bulk"]
    if smoke:
        shape = smoke_shape(shape, batch=SERVE_ROWS["smoke"])
    model = run.model(name, cfg, MODELS[name])
    batch = _ctr_batch(cfg, shape.get("batch"), run.seed + 5)
    if smoke:
        run.put(f"serve:{name}/inputs", batch)
    b = to_device(batch, run.device)
    step = arch.make_step(cfg, shape, run.device, run.mesh)
    got = run.sharded(f"serve:{name}", lambda: step.step_fn(model, b))
    want = arch.make_step(cfg, shape, run.device).step_fn(model, b)
    run.put(f"serve:{name}/got", got)
    run.put(f"serve:{name}/want", want)


def eval_case(run: _Run) -> None:
    """The eval arch on the mesh (the query axis padded to its size)."""
    from repro_torch.configs.common import smoke_shape
    from repro_torch.core import measures as M
    from repro_torch.launch.api import get_arch

    arch = get_arch("pytrec-eval")
    cfg = arch.make_config(True)
    rng = np.random.default_rng(run.seed + 6)
    q, d = 10, 24
    scores = rng.standard_normal((q, d)).astype(np.float32)
    rel = rng.integers(0, 3, (q, d)).astype(np.float32)
    run.put("eval/inputs", {"scores": scores, "rel": rel})
    shape = smoke_shape(arch.shapes["eval_10k_1k"], n_queries=q, n_docs=d,
                        n_judged=d)
    step = arch.make_step(cfg, shape, run.device, run.mesh)
    qp = step.arg_specs[0].scores.shape[0]  # padded to a mesh multiple

    def dense(n):
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.pad(a, ((0, n - q), (0, 0)))).to(run.device)
        qm = torch.arange(n, device=run.device) < q
        return M.batch_from_dense(t(scores), t(rel), query_mask=qm)

    got = run.sharded("eval", lambda: step.step_fn(dense(qp)))
    want = arch.make_step(cfg, shape, run.device).step_fn(dense(q))
    run.put("eval/got", got)
    run.put("eval/want", want)


def gather_case(run: _Run) -> None:
    """``sharding.full_tensor`` of uneven blocks: 5 rows over the data
    axes, 7 columns over ``model``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import data_axes_of

    t = torch.arange(35, dtype=torch.float32, device=run.device).reshape(
        5, 7)
    spec = (data_axes_of(run.mesh), "model")
    run.put("gather/got", run.sharded(
        "gather", lambda: SH.full_tensor(SH.to_dtensor(t, spec, run.mesh))))
    run.put("gather/want", t)


CASES = {"lm": lm_case, "moe": moe_case, "retrieval": retrieval_case,
         "serve": serve_case}
#: the CPU test's cases; the last LM case's 3 query heads (one KV head)
#: do not split over 2 ranks
SMOKE_CASES = ("lm:olmo-1b", "lm:qwen3-moe-235b-a22b", "lm:arctic-480b",
               "lm:phi3-medium-14b:n_heads=3:n_kv_heads=1:d_model=48",
               "moe:arctic-480b", "lookup", "retrieval:sasrec",
               "serve:xdeepfm", "eval", "gather")


def run_cases(mesh, device, size, cases, seed=0, weights=None) -> _Run:
    run = _Run(mesh, device, size, seed, weights)
    for case in cases:
        kind, _, arg = case.partition(":")
        if kind == "lookup":
            lookup_case(run)
        elif kind == "gather":
            gather_case(run)
        elif kind == "eval":
            eval_case(run)
        else:
            CASES[kind](run, arg)
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sharded_serve",
        description="Model-parallel serving against the unsharded steps "
                    "over a process group (torchrun sets RANK and "
                    "WORLD_SIZE; or pass --store, --rank, --world-size).")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL ranks (their product is the world)")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (the card of LOCAL_RANK) or cuda:N")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on CUDA, else gloo)")
    ap.add_argument("--store", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--size", choices=("smoke", "card"), default="smoke")
    ap.add_argument("--cases", default=",".join(SMOKE_CASES))
    ap.add_argument("--weights", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rank = args.rank if args.rank is not None else int(
        os.environ.get("RANK", 0))
    world = args.world_size if args.world_size is not None else int(
        os.environ.get("WORLD_SIZE", 1))
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            ap.error("CUDA device requested but torch.cuda.is_available() "
                     "is False; pass --device cpu")
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", rank))
                % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # the unsharded reference in float32 without TF32, as JAX's
        torch.backends.cuda.matmul.allow_tf32 = False
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"timeout": GROUP_TIMEOUT, "rank": rank, "world_size": world}
    if args.store is not None:
        kw["store"] = dist.FileStore(args.store, world)
    dist.init_process_group(backend, **kw)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        dp, mp = (int(x) for x in args.mesh.split("x"))
        if dp * mp != world:
            ap.error(f"mesh {args.mesh} needs {dp * mp} ranks, have {world}")
        mesh = make_host_mesh(mp, device=device)
        t0 = time.perf_counter()
        run = run_cases(mesh, device, args.size,
                        [c for c in args.cases.split(",") if c], args.seed,
                        args.weights)
        seconds = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{rank}.npz"), **run.out)
    print(json.dumps({"rank": rank, "world_size": world, "mesh": args.mesh,
                      "backend": backend, "device": str(device),
                      "launches": run.launches,
                      "case_seconds": run.seconds,
                      "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
