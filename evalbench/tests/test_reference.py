"""The reference against hand-worked cases and trec_eval's golden output,
and the control: a computation one precision lower fails the check."""

import math

import numpy as np
import pytest

from evalbench import check, data
from evalbench.reference import trec_eval as T
from evalbench.tests.conftest import ROOT, TINY

FIXTURES = ROOT / "tests" / "fixtures"
ALL = ["num_ret", "num_rel", "num_rel_ret", "map", "gm_map", "Rprec",
       "bpref", "recip_rank", "iprec_at_recall", "P", "recall", "ndcg",
       "ndcg_cut", "map_cut", "success"]


def _fixture():
    qrel = [line.split() for line in open(FIXTURES / "conformance.qrel")]
    run = [line.split() for line in open(FIXTURES / "conformance.run")]
    prep = T.prepare([r[0] for r in qrel], [r[2] for r in qrel],
                     [int(r[3]) for r in qrel], [r[0] for r in run],
                     [r[2] for r in run])
    scores = np.array([float(r[4]) for r in run], np.float32)
    return prep, T.evaluate(prep, scores, ALL)


def test_hand_worked_fixture():
    # q1 ranks APPLE(2), MANGO(unjudged), CHERRY(0), BANANA(1): the 2.0
    # tie goes to MANGO ('M' > 'C'); R = 3, one judged non-relevant
    prep, out = _fixture()
    q1 = prep.qids.index("q1")
    l3, l5 = math.log2(3), math.log2(5)
    want = {"map": 0.5, "recip_rank": 1.0, "Rprec": 1 / 3, "bpref": 1 / 3,
            "ndcg": (2 + 1 / l5) / (2 + 1 / l3 + 0.5), "P_5": 0.4,
            "recall_5": 2 / 3, "success_1": 1.0, "num_ret": 4.0,
            "num_rel": 3.0, "num_rel_ret": 2.0, "map_cut_5": 0.5,
            "gm_map": math.log(0.5), "iprec_at_recall_0.30": 1.0,
            "iprec_at_recall_0.40": 0.5, "iprec_at_recall_0.70": 0.0}
    for k, v in want.items():
        assert out[k][q1] == pytest.approx(v, abs=1e-12), k


def test_golden_summary():
    prep, out = _fixture()
    summ = T.summary(out)
    sums = {"num_ret", "num_rel", "num_rel_ret"}
    seen = 0
    for line in open(FIXTURES / "conformance.golden"):
        key, q, val = line.split()
        if q != "all" or key not in out:
            continue
        got = float(out[key].sum()) if key in sums else summ[key]
        fmt = "{:.0f}" if key in sums else "{:.4f}"
        assert fmt.format(got) == val, key
        seen += 1
    assert seen == 59


def _run(rows, relevant):
    """A run of (qid, docno, score) rows; the docnos in ``relevant`` are
    judged relevant (grade 1), the rest unjudged."""
    prep = T.prepare([r[0] for r in rows if r[1] in relevant],
                     [r[1] for r in rows if r[1] in relevant],
                     [1] * sum(r[1] in relevant for r in rows),
                     [r[0] for r in rows], [r[1] for r in rows])
    return prep, np.array([r[2] for r in rows], np.float32)


@pytest.mark.parametrize("docs,relevant,rr", [
    (["a", "b"], "a", 0.5),      # equal scores: the larger docno first
    (["10", "9"], "9", 1.0),     # strcmp order, not numeric: "9" > "10"
    (["ab", "abc"], "ab", 0.5),  # a prefix sorts below
])
def test_docno_tie_rule(docs, relevant, rr):
    prep, scores = _run([("q", docs[0], 1.0), ("q", docs[1], 1.0)],
                        {relevant})
    got = T.evaluate(prep, scores, ["recip_rank"])["recip_rank"][0]
    assert got == rr


def test_negative_zero_ties_zero():
    # -0.0 and 0.0 are one score, so the docno decides: "x" > "r"
    prep, _ = _run([("q", "r", 0.0), ("q", "x", 0.0)], {"r"})
    for scores in ([0.0, -0.0], [-0.0, 0.0]):
        rr = T.evaluate(prep, np.array(scores, np.float32),
                        ["recip_rank"])["recip_rank"][0]
        assert rr == 0.5


def test_iprec_targets_are_exact():
    # recall 0.3 of R = 50 is reached by the 15th relevant document, as
    # trec_eval counts it in double; a float32 product rounds 0.3 * 50
    # up to 15.000001 and would ask for a 16th
    rows = [("q", f"r{i:03d}", 100.0 - i) for i in range(50)]
    rows += [("q", f"x{i:03d}", 200.0 - i) for i in range(20)]
    prep, scores = _run(rows, {r[1] for r in rows if r[1][0] == "r"})
    out = T.evaluate(prep, scores, ["iprec_at_recall.0.3"])
    # the 15th relevant sits at rank 35: 15 / 35; later ranks only grow
    best = max((k - 20) / k for k in range(35, 71))
    assert out["iprec_at_recall_0.30"][0] == pytest.approx(best)


def test_relevance_level():
    rows = [("q", "a", 2.0), ("q", "b", 1.0)]
    prep = T.prepare(["q", "q"], ["a", "b"], [1, 2], ["q", "q"], ["a", "b"],
                     relevance_level=2)
    out = T.evaluate(prep, np.array([r[2] for r in rows], np.float32),
                     ["recip_rank", "num_rel"])
    assert out["num_rel"][0] == 1.0 and out["recip_rank"][0] == 0.5


def _tiny_collection(name, seed=5):
    cfg = {**data.load_config(name), **TINY[name]}
    col = data.collection(cfg, seed)
    return cfg, col, data.score_pool(cfg, col, seed, 2)


@pytest.mark.parametrize("name,measures", [
    ("msmarco-dev", ["map", "ndcg", "ndcg_cut", "P", "recall", "recip_rank",
                     "Rprec", "bpref", "success", "map_cut"]),
    ("robust04", ["map", "P.20", "ndcg_cut.20"]),
])
def test_lower_precision_fails_the_check(name, measures):
    cfg, col, pool = _tiny_collection(name)
    ref = check.Reference(col, measures, 1)
    low = check.Reference(col, measures, 1, lower_precision=True)
    want = [ref.per_query(pool[0])]
    keys = ref.keys
    for side in ("float32", "bfloat16"):
        if side == "float32":  # the values rounded as the port returns them
            got = {k: v.astype(np.float32) for k, v in want[0].items()}
        else:
            got = low.per_query(pool[0])
        table = np.stack([got[k] for k in keys], axis=-1)[None]
        r = check.compare("per_query", ref.prep.qids, keys, table, want, ref)
        if side == "float32":
            assert r["max_gap"] < 1e-6 and r["missing"] == 0
        else:
            assert r["max_gap"] > 1e-3
