"""Batched recsys serving with in-loop evaluation, on the PyTorch port.

A SASRec ranker answers batched slate-ranking requests; NDCG@10 / MRR of
every response batch is computed inside the same step from the scores on
the device (the pytrec_eval pattern: evaluation lives with the scores).  A
second phase takes the top 1,000 of many candidates through the port's
top-k (the CUDA kernel on a card, its plain version on the CPU).

    PYTHONPATH=src python examples/torch_serve_recsys.py [--requests 20] \
        [--device cpu]

The counterpart of ``serve_recsys.py``; ``--device`` defaults to ``cuda``.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.common import smoke_shape
from repro_torch.kernels import ops
from repro_torch.kernels.topk import topk_plain
from repro_torch.launch.api import get_arch, to_device
from repro_torch.models.recsys import SASRec, SASRecConfig


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--slate", type=int, default=128)
    ap.add_argument("--n-items", type=int, default=50_000)
    ap.add_argument("--n-candidates", type=int, default=200_000)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    device = args.device

    cfg = SASRecConfig(name="serve", n_items=args.n_items, embed_dim=50,
                       n_blocks=2, n_heads=1, seq_len=50)
    gen = torch.Generator(device=device).manual_seed(0)
    model = SASRec(cfg, device=device, generator=gen)
    arch = get_arch("sasrec")
    shape = smoke_shape(arch.shapes["serve_p99"], batch=args.batch,
                        slate=args.slate)
    serve = arch.make_step(cfg, shape, device=device).step_fn

    rng = np.random.default_rng(0)
    lat = []
    print(f"serving {args.requests} request batches "
          f"(batch={args.batch}, slate={args.slate}) on {device}...")
    for i in range(args.requests):
        ids = lambda: rng.integers(  # noqa: E731
            0, cfg.n_items, (args.batch, cfg.seq_len)).astype(np.int32)
        batch = {"items": ids(), "pos": ids(), "neg": ids(),
                 "mask": np.ones((args.batch, cfg.seq_len), bool)}
        cand = rng.integers(0, cfg.n_items,
                            (args.batch, args.slate)).astype(np.int32)
        rel = np.zeros((args.batch, args.slate), np.int32)
        rel[:, rng.integers(0, args.slate)] = 1
        t0 = time.perf_counter()
        scores, metrics = serve(model, *to_device((batch, cand, rel),
                                                  device))
        _sync(device)
        lat.append(time.perf_counter() - t0)
        if i % 5 == 0:
            print(f"  req {i}: ndcg@10={float(metrics['ndcg_cut_10']):.4f} "
                  f"mrr={float(metrics['recip_rank']):.4f} "
                  f"({lat[-1]*1e3:.1f} ms)")
    lat_ms = np.array(lat[1:]) * 1e3  # drop the first (warm-up) request
    print(f"latency p50={np.percentile(lat_ms, 50):.1f}ms "
          f"p99={np.percentile(lat_ms, 99):.1f}ms")

    # --- retrieval: top-1000 of n_candidates through the port's top-k ------
    print(f"\nretrieval: top-1000 of {args.n_candidates} candidates...")
    user = torch.from_numpy(
        rng.standard_normal((1, 50)).astype(np.float32)).to(device)
    cand_emb = torch.from_numpy(rng.standard_normal(
        (args.n_candidates, 50)).astype(np.float32)).to(device)
    scores = (user @ cand_emb.T).contiguous()
    t0 = time.perf_counter()
    v, i = ops.topk(scores, 1000)
    _sync(device)
    print(f"  top-1000 done in {time.perf_counter()-t0:.4f}s; "
          f"best score {float(v[0, 0]):.3f} @ item {int(i[0, 0])}")
    rv, ri = topk_plain(scores.cpu(), 1000)
    assert torch.equal(i.cpu(), ri), "top-k disagrees with its plain version"
    print("  verified against the plain PyTorch top-k")


if __name__ == "__main__":
    main()
