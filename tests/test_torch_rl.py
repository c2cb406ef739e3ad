"""The port's synthetic collection and Q-learning loop against the JAX
package's, on the CPU.

``repro_torch.data.synthetic_ir`` is a numpy copy, so a seed must give
byte-identical collections, query-likelihood scores and runs.  The
query-expansion environment evaluates each step with the port's evaluator:
a fixed action sequence must give the JAX environment's observations,
done flags and rewards (within 2e-4, the evaluator's tolerance for
``ndcg``), and the agent, trained with the same seed and config, the JAX
agent's rewards and Q-table.
"""

import numpy as np
import pytest

from repro.data import synthetic_ir as JSIR
from repro.rl.environment import EnvConfig as JaxEnvConfig
from repro.rl.environment import QueryExpansionEnv as JaxEnv

from repro_torch.data import synthetic_ir as SIR
from repro_torch.rl.environment import EnvConfig, QueryExpansionEnv
from repro_torch.rl.qlearning import QLearningAgent, QLearningConfig

from test_torch_measures import single_torch_thread  # noqa: F401

CFG = dict(vocab_size=60, n_docs=15, n_queries=8, avg_doc_len=40,
           avg_query_len=2, seed=2)


@pytest.fixture(scope="module")
def collections():
    return (SIR.build_collection(SIR.CollectionConfig(**CFG)),
            JSIR.build_collection(JSIR.CollectionConfig(**CFG)))


@pytest.mark.parametrize("cfg", [
    CFG,
    # sparse successor table (|V| above the dense-bigram threshold)
    dict(vocab_size=600, n_docs=6, n_queries=3, avg_doc_len=30, seed=5),
])
def test_build_collection_is_byte_identical(cfg):
    got = SIR.build_collection(SIR.CollectionConfig(**cfg))
    want = JSIR.build_collection(JSIR.CollectionConfig(**cfg))
    for name in ("doc_term", "doc_len", "coll_freq"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert got.qrels == want.qrels
    assert list(got.query_terms) == list(want.query_terms)
    for qid, terms in want.query_terms.items():
        assert got.query_terms[qid].tobytes() == terms.tobytes()


def test_scores_runs_and_benchmark_synthesis_are_byte_identical(collections):
    coll, jcoll = collections
    scores, jscores = {}, {}
    for qid, terms in jcoll.query_terms.items():
        scores[qid] = SIR.ql_scores(coll, coll.query_terms[qid])
        jscores[qid] = JSIR.ql_scores(jcoll, terms)
        assert scores[qid].tobytes() == jscores[qid].tobytes()
    assert SIR.run_from_scores(coll, scores, 7) == \
        JSIR.run_from_scores(jcoll, jscores, 7)
    assert SIR.ql_scores(coll, np.array([], np.int64)).tobytes() == \
        JSIR.ql_scores(jcoll, np.array([], np.int64)).tobytes()
    assert SIR.synthesize_run(5, 9, seed=3) == JSIR.synthesize_run(5, 9,
                                                                   seed=3)


def test_env_rewards_match_jax_for_a_fixed_action_sequence(collections):
    coll, jcoll = collections
    env = QueryExpansionEnv(coll, EnvConfig(depth=10, max_actions=4),
                            device="cpu")
    jenv = JaxEnv(jcoll, JaxEnvConfig(depth=10, max_actions=4))
    assert env.n_actions == jenv.n_actions == CFG["vocab_size"] + 1
    actions = [3, 17, CFG["vocab_size"], 41]  # the third is the no-op
    for qid in list(jcoll.qrels)[:3]:
        assert np.array_equal(env.reset(qid), jenv.reset(qid))
        for a in actions:
            obs, reward, done, info = env.step(a)
            jobs, jreward, jdone, jinfo = jenv.step(a)
            assert np.array_equal(obs, jobs) and done == jdone
            assert reward == pytest.approx(jreward, abs=2e-4)
            assert info["ndcg"] == pytest.approx(jinfo["ndcg"], abs=2e-4)
            if done:
                break


@pytest.mark.parametrize("epsilon", [0.05, 0.5])
def test_qlearning_agent_matches_jax(collections, epsilon):
    """The port's agent and the JAX package's, given the same seed and
    config, draw the same candidate actions and, episode by episode, earn
    the same rewards and fill the same Q-table.  ``epsilon = 0.5`` takes the
    exploring branch often as well as the greedy one."""
    from repro.rl.qlearning import QLearningAgent as JaxAgent
    from repro.rl.qlearning import QLearningConfig as JaxConfig

    coll, jcoll = collections
    kw = dict(alpha=0.1, gamma=0.95, epsilon=epsilon, n_candidate_actions=16,
              seed=0)
    env = QueryExpansionEnv(coll, EnvConfig(depth=10, max_actions=3),
                            device="cpu")
    jenv = JaxEnv(jcoll, JaxEnvConfig(depth=10, max_actions=3))
    agent = QLearningAgent(env, QLearningConfig(**kw))
    jagent = JaxAgent(jenv, JaxConfig(**kw))
    assert agent.actions.tolist() == jagent.actions.tolist()
    assert agent.actions[-1] == CFG["vocab_size"]  # the no-op

    qids = list(coll.qrels)[:4]
    rewards = agent.train(qids, episodes=12)
    jrewards = jagent.train(qids, episodes=12)
    # within 2e-4, the evaluator's tolerance for ndcg, episode by episode
    assert len(rewards) == len(jrewards) == 12
    np.testing.assert_allclose(rewards, jrewards, rtol=0, atol=2e-4)
    # q <- (1 - a) q + a (r + g max q') keeps the error of every entry
    # within err(r) / (1 - g) when each reward is within err(r)
    assert agent.q.keys() == jagent.q.keys()
    q_tol = 2e-4 / (1 - kw["gamma"])
    for key, qv in jagent.q.items():
        np.testing.assert_allclose(agent.q[key], qv, rtol=0, atol=q_tol)
    assert any(np.any(qv != 0) for qv in agent.q.values())
    # the agents leave their generators in the same state
    assert agent.rng.random() == jagent.rng.random()
    obs = env.reset(qids[0])
    assert 0 <= agent.act(obs) < len(agent.actions)
