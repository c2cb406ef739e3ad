"""Tabular Q-learning agent (paper §4: α=0.1, γ=0.95, ε=0.05), PyTorch port.

The agent is host-side numpy, as in ``repro.rl.qlearning``; its
environment evaluates each step on the environment's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.rl.environment import QueryExpansionEnv


@dataclasses.dataclass
class QLearningConfig:
    alpha: float = 0.1
    gamma: float = 0.95
    epsilon: float = 0.05
    # action sub-sampling keeps the tabular policy tractable on big vocabs
    n_candidate_actions: int = 64
    seed: int = 0


class QLearningAgent:
    def __init__(self, env: QueryExpansionEnv, cfg: QLearningConfig):
        self.env = env
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.q: Dict[Tuple, np.ndarray] = {}
        # fixed candidate action set (uniform vocab sample + no-op)
        v = env.coll.cfg.vocab_size
        n = min(cfg.n_candidate_actions, v)
        self.actions = np.concatenate(
            [self.rng.choice(v, size=n, replace=False), [v]])

    def _state_key(self, obs: np.ndarray) -> Tuple:
        return tuple(np.flatnonzero(obs).tolist())

    def _qvals(self, key: Tuple) -> np.ndarray:
        if key not in self.q:
            self.q[key] = np.zeros(len(self.actions), dtype=np.float64)
        return self.q[key]

    def act(self, obs: np.ndarray) -> int:
        if self.rng.random() < self.cfg.epsilon:
            return int(self.rng.integers(len(self.actions)))
        return int(np.argmax(self._qvals(self._state_key(obs))))

    def episode(self, qid: str) -> float:
        """One training episode; returns total reward (ΔNDCG)."""
        obs = self.env.reset(qid)
        total = 0.0
        done = False
        while not done:
            a_idx = self.act(obs)
            new_obs, reward, done, _ = self.env.step(int(self.actions[a_idx]))
            total += reward
            key, new_key = self._state_key(obs), self._state_key(new_obs)
            qv = self._qvals(key)
            target = reward + (0.0 if done else
                               self.cfg.gamma * self._qvals(new_key).max())
            qv[a_idx] += self.cfg.alpha * (target - qv[a_idx])
            obs = new_obs
        return total

    def train(self, qids: List[str], episodes: int,
              log_every: int = 0) -> List[float]:
        rewards = []
        for ep in range(episodes):
            qid = qids[int(self.rng.integers(len(qids)))]
            rewards.append(self.episode(qid))
            if log_every and (ep + 1) % log_every == 0:
                avg = float(np.mean(rewards[-log_every:]))
                print(f"episode {ep + 1}: avg reward {avg:+.4f}")
        return rewards
