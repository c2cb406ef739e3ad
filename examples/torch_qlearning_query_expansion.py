"""Paper §4 end-to-end on the PyTorch port: Q-learning query expansion.

Pipeline (all in-process, the point of the paper):
  synthetic Tague-style collection → Dirichlet-QL ranking (the Pyndri role)
  → ΔNDCG reward from the evaluator on ``--device`` (the pytrec_eval role)
  → tabular Q-learning agent (α=0.1, γ=0.95, ε=0.05).

    PYTHONPATH=src python examples/torch_qlearning_query_expansion.py \
        [--episodes 600] [--paper-scale] [--device cpu]

The counterpart of ``qlearning_query_expansion.py``; ``--device``
defaults to ``cuda``.
"""

import argparse

import numpy as np

from repro_torch.data import synthetic_ir as sir
from repro_torch.rl.environment import EnvConfig, QueryExpansionEnv
from repro_torch.rl.qlearning import QLearningAgent, QLearningConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=600)
    ap.add_argument("--paper-scale", action="store_true",
                    help="|V|=10k, |D|=100, μ_d=200, 100k queries (slow)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    if args.paper_scale:
        cfg = sir.CollectionConfig(vocab_size=10_000, n_docs=100,
                                   n_queries=100_000, avg_doc_len=200)
    else:
        cfg = sir.CollectionConfig(vocab_size=500, n_docs=60, n_queries=16,
                                   avg_doc_len=80)
    print(f"building collection |V|={cfg.vocab_size} |D|={cfg.n_docs} "
          f"|Q|={cfg.n_queries} ...")
    coll = sir.build_collection(cfg)

    env = QueryExpansionEnv(coll, EnvConfig(depth=10, max_actions=5,
                                            mu=2500.0), device=args.device)
    agent = QLearningAgent(env, QLearningConfig(
        alpha=0.1, gamma=0.95, epsilon=0.05,
        n_candidate_actions=min(128, cfg.vocab_size)))

    qids = list(coll.qrels)[:64]
    rewards = agent.train(qids, episodes=args.episodes,
                          log_every=max(args.episodes // 10, 1))

    w = max(args.episodes // 10, 1)
    smoothed = np.convolve(rewards, np.ones(w) / w, mode="valid")
    print("\naverage reward (ΔNDCG) over training — paper Fig. 3:")
    cols = 60
    lo, hi = float(smoothed.min()), float(smoothed.max())
    span = max(hi - lo, 1e-9)
    for i in range(0, len(smoothed), max(len(smoothed) // 20, 1)):
        bar = "#" * int((smoothed[i] - lo) / span * cols)
        print(f"  ep {i + w:5d} {smoothed[i]:+.4f} |{bar}")
    print(f"\nfirst-{w} avg: {np.mean(rewards[:w]):+.4f}   "
          f"last-{w} avg: {np.mean(rewards[-w:]):+.4f}")


if __name__ == "__main__":
    main()
