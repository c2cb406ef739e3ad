"""Query-expansion environment (paper §4, gym-style contract), PyTorch port.

State: the set of terms in the expanded query (observation = binary vocab
vector).  Action: add one vocabulary term (or no-op).  Reward: ΔNDCG of the
re-ranked top-10 — computed by the in-process evaluator on every step, which
is exactly the workload pytrec_eval makes cheap (the serialize-invoke-parse
equivalent would fork a process per env step).

Episodes terminate after ``max_actions`` expansions or a perfect NDCG.
The reward's evaluation runs on ``device`` (CUDA unless the caller passes
``device="cpu"``); ranking and the observation stay on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import RelevanceEvaluator
from repro_torch.data import synthetic_ir as sir


@dataclasses.dataclass
class EnvConfig:
    depth: int = 10
    max_actions: int = 5
    mu: float = 2500.0
    measure: str = "ndcg"


class QueryExpansionEnv:
    def __init__(self, collection: sir.Collection,
                 cfg: Optional[EnvConfig] = None, device=None):
        self.coll = collection
        self.cfg = cfg or EnvConfig()
        self.evaluator = RelevanceEvaluator(collection.qrels,
                                            {self.cfg.measure}, device=device)
        self._qid: Optional[str] = None
        self._terms: Optional[np.ndarray] = None
        self._ndcg: float = 0.0
        self._steps = 0

    @property
    def n_actions(self) -> int:
        return self.coll.cfg.vocab_size + 1  # + no-op

    def _evaluate(self) -> float:
        scores = sir.ql_scores(self.coll, self._terms, self.cfg.mu)
        run = sir.run_from_scores(self.coll, {self._qid: scores},
                                  self.cfg.depth)
        res = self.evaluator.evaluate(run)
        return float(res[self._qid][self.cfg.measure])

    def reset(self, qid: str) -> np.ndarray:
        self._qid = qid
        self._terms = np.array(self.coll.query_terms[qid], dtype=np.int64)
        self._steps = 0
        self._ndcg = self._evaluate()
        return self.observation()

    def observation(self) -> np.ndarray:
        obs = np.zeros(self.coll.cfg.vocab_size, dtype=bool)
        obs[self._terms] = True
        return obs

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, Dict]:
        assert self._qid is not None, "call reset() first"
        self._steps += 1
        if action < self.coll.cfg.vocab_size:  # expansion (else: no-op)
            self._terms = np.append(self._terms, action)
        new_ndcg = self._evaluate()
        reward = new_ndcg - self._ndcg
        self._ndcg = new_ndcg
        done = (self._steps >= self.cfg.max_actions) or new_ndcg >= 1.0
        return self.observation(), reward, done, {self.cfg.measure: new_ndcg}
