"""The generator: sizes as the configuration files state, and the same
data from the same seed."""

import numpy as np
import pytest

from evalbench import data
from evalbench.tests.conftest import TINY


def test_msmarco_plan_matches_its_file():
    cfg = data.load_config("msmarco-dev")
    p = data.plan(cfg)
    pub = cfg["published"]
    assert len(p["rel"]) == pub["queries"] == 6980
    assert p["rel"].sum() == p["judged"].sum() == pub["judgments"] == 7437
    assert set(p["rel"].tolist()) == {1, 2, 3, 4}
    assert p["cands"].sum() == pub["candidate_pairs"] == 6668967
    assert p["cands"].max() == 1000 and (p["cands"] < 1000).any()
    assert p["rel_ret"].sum() == round(0.857 * 6980)


def test_robust04_plan_matches_its_file():
    cfg = data.load_config("robust04")
    p = data.plan(cfg)
    pub = cfg["published"]
    assert len(p["rel"]) == pub["topics"] == 249
    assert p["judged"].sum() == pub["judgments"] == 311410
    assert p["rel"].sum() == pub["relevant"] == 17412
    assert p["judged"].max() <= 2048 and (p["judged"] >= p["rel"]).all()
    assert p["cands"].sum() == 249 * 1000
    assert p["rel_ret"].sum() == round(0.70 * 17412)
    assert p["judged_ret"].sum() == round(0.30 * 249000)


def test_robust04_collection_at_full_size():
    cfg = data.load_config("robust04")
    col = data.collection(cfg, 2**31 + 7)
    assert len(col.qrel_qid) == 311410 and len(col.run_qid) == 249000
    assert (np.bincount(col.qrel_grade) > 0).all()
    assert len(np.unique(col.run_qid)) == 249
    pairs = np.char.add(np.char.add(col.run_qid, " "), col.run_doc)
    assert len(np.unique(pairs)) == len(pairs)
    styles = {d.split("-")[0][:2] for d in col.run_doc[:2000].tolist()}
    assert styles <= {"FB", "FR", "FT", "LA"} and len(styles) > 2


@pytest.mark.parametrize("name", sorted(TINY))
def test_same_seed_same_data(name):
    cfg = {**data.load_config(name), **TINY[name]}
    a, b = data.collection(cfg, 99), data.collection(cfg, 99)
    c = data.collection(cfg, 2**31 + 99)
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x, y)
    # another seed: other ids and scores, the same amount of work
    assert len(a.run_qid) == len(c.run_qid)
    assert len(a.qrel_qid) == len(c.qrel_qid)
    assert not np.array_equal(a.run_doc, c.run_doc)
    pa = data.score_pool(cfg, a, 99, 2)
    assert np.array_equal(pa, data.score_pool(cfg, b, 99, 2))
    assert pa.dtype == np.float32 and not np.array_equal(pa[0], pa[1])
    assert np.array_equal(pa, np.round(pa.astype(np.float64), 4)
                          .astype(np.float32))


def test_decimal_strings_are_str():
    ids = np.array([0, 7, 10, 99, 100, 8841822, 123456])
    assert data.decimal_strings(ids).tolist() == [str(i) for i in ids]
