"""Quickstart on the PyTorch port: the paper's Code snippet 1.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``quickstart.py``; evaluation runs on ``--device``
(default ``cuda``, which raises on a host without a card).
"""

import argparse

import numpy as np
import torch

import repro_torch.core as core  # pytrec_eval-compatible surface


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args().device

    # --- the paper's minimal example (Code snippet 1) -----------------------
    qrel = {
        "q1": {"d1": 0, "d2": 1},
        "q2": {"d1": 1},
    }
    evaluator = core.RelevanceEvaluator(qrel, {"map", "ndcg"}, device=device)
    run = {
        "q1": {"d1": 1.0, "d2": 0.0},
        "q2": {"d1": 1.5, "d2": 0.2},
    }
    results = evaluator.evaluate(run)
    print("per-query:", results)
    print("aggregate:", core.aggregate_results(results))

    # --- all trec_eval measures (the '-m all_trec' pattern) ----------------
    full = core.RelevanceEvaluator(qrel, core.supported_measures,
                                   device=device)
    print("\nsupported measure families:", sorted(core.supported_measures))
    q1 = full.evaluate(run)["q1"]
    print(f"q1 has {len(q1)} measure values, e.g. "
          f"ndcg_cut_10={q1['ndcg_cut_10']:.4f} P_5={q1['P_5']:.4f}")

    # --- device-resident batched evaluation --------------------------------
    rng = np.random.default_rng(0)
    scores = torch.from_numpy(
        rng.standard_normal((128, 100)).astype(np.float32)).to(device)
    rel = torch.from_numpy(
        (rng.random((128, 100)) < 0.1).astype(np.float32)).to(device)
    batch = core.batch_from_dense(scores, rel)
    per_query = core.compute_measures(batch,
                                      core.parse_measures(("ndcg", "map")))
    print(f"\nbatched on {device}: 128 queries evaluated in one call; "
          f"mean ndcg={float(per_query['ndcg'].mean()):.4f}")


if __name__ == "__main__":
    main()
