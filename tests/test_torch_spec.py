"""The port's measure registry and bucketing against the JAX package's.

``repro_torch`` keeps its own copies of ``repro.core.registry`` and
``repro.kernels.bucketing`` (importing them would pull in JAX); every
spelling, key, depth bound and padding class must come out the same.
"""

import doctest
import importlib

import pytest

from repro.core import registry as JR
from repro.kernels import bucketing as JB

from repro_torch.core import registry as TR
from repro_torch.kernels import bucketing as TB

# every spelling of tests/test_registry.py, plus families and grids
SPELLINGS = [
    "map", "AP", "MAP", "gm_map", "GMAP", "recip_rank", "RR", "MRR",
    "Rprec", "bpref", "Bpref", "ndcg", "nDCG", "P_5", "P@5", "recall_10",
    "R@10", "Recall@10", "ndcg_cut_10", "nDCG@10", "map_cut_20", "AP@20",
    "success_1", "Success@1", "judged_10", "Judged@10", "err_20", "ERR@20",
    "rbp_0.80", "RBP(p=0.8)", "iprec_at_recall_0.10", "IPrec@0.10",
    "num_ret", "NumRet", "num_rel", "NumRel", "num_rel_ret", "NumRelRet",
    "ap", "Ap", "ndcg@10", "NDCG@10", "judged@5", "P", "P.5,10",
    "ndcg_cut", "success", "iprec_at_recall", "AP(rel=2)", "P(rel=2)@5",
    "RBP(p=0.5)", "err", "judged", "rbp",
]

BAD = ["bogus", "Bogus@5", "P_5.5", "P@0", "ndcg_cut_0", "RBP(p=1.5)",
       "RBP(p=0.875)", "AP(frobnicate=1)", "AP(rel=x)", "RR@5",
       "iprec_at_recall_1.50", ""]


def _outcome(fn, *args, **kwargs):
    """(result, None) or (None, (error type name, message))."""
    try:
        return fn(*args, **kwargs), None
    except Exception as e:  # noqa: BLE001 - the comparison is the point
        return None, (type(e).__name__, str(e))


def test_registry_table_is_identical():
    assert TR.REGISTRY == JR.REGISTRY
    assert TR.DEFAULT_CUTOFFS == JR.DEFAULT_CUTOFFS
    assert TR.SUCCESS_CUTOFFS == JR.SUCCESS_CUTOFFS
    assert TR.IPREC_LEVELS == JR.IPREC_LEVELS
    assert (TR.GM_MIN, TR.DEFAULT_RBP_P) == (JR.GM_MIN, JR.DEFAULT_RBP_P)


def test_derived_tables_are_identical():
    assert TR.family_order() == JR.family_order()
    assert TR.integer_keys() == JR.integer_keys()
    assert TR.sum_families() == JR.sum_families()
    assert TR.aggregate_only_families() == JR.aggregate_only_families()
    assert TR.supported_families() == JR.supported_families()


@pytest.mark.parametrize("spelling", SPELLINGS)
def test_spelling_gives_same_canonical_keys(spelling):
    assert _outcome(TR.canonicalize, [spelling]) == \
        _outcome(JR.canonicalize, [spelling])
    assert _outcome(TR.canonical_key, spelling) == \
        _outcome(JR.canonical_key, spelling)
    parsed, _ = JR.canonicalize([spelling])
    assert TR.keys_for(parsed) == JR.keys_for(parsed)
    assert TR.topk_depth(parsed) == JR.topk_depth(parsed)


@pytest.mark.parametrize("bad", BAD)
def test_malformed_measure_fails_the_same_way(bad):
    got = _outcome(TR.canonicalize, [bad])
    assert got[1] is not None and got[1][0] == "MeasureError"
    assert got == _outcome(JR.canonicalize, [bad])


@pytest.mark.parametrize("measures,level", [
    (["AP(rel=2)", "P(rel=3)@5"], None),
    (["AP(rel=2)"], 3),
    (["AP(rel=2)"], 1),
    (["AP(rel=2)", "P(rel=2)@5", "ndcg"], None),
    (["P@5", "P_10", "P.15,20"], None),
])
def test_rel_resolution_is_identical(measures, level):
    assert _outcome(TR.canonicalize, measures, level) == \
        _outcome(JR.canonicalize, measures, level)
    assert _outcome(TR.parse_measures, measures) == \
        _outcome(JR.parse_measures, measures)


@pytest.mark.parametrize("measures", [
    ["P@5", "nDCG@100", "Judged@10"], ["P@5", "num_ret", "num_rel"],
    ["P", "recall", "ndcg_cut", "map_cut", "success"], ["map", "P@5"],
    ["rbp_0.80", "P@5"], ["gm_map"], ["iprec_at_recall"], ["err"],
    ["num_rel_ret", "P_10"],
])
def test_topk_depth_agrees(measures):
    parsed, _ = JR.canonicalize(measures)
    assert TR.topk_depth(parsed) == JR.topk_depth(parsed)


def test_every_default_key_renders_and_splits_the_same():
    for spec in JR.REGISTRY:
        for key in JR.family_keys(spec.family, spec.default_params):
            assert TR.family_keys(spec.family, spec.default_params) == \
                JR.family_keys(spec.family, spec.default_params)
            assert TR.render_ir(key) == JR.render_ir(key)
            assert TR.render_trec(JR.render_ir(key)) == key
            assert TR.split_key(key) == JR.split_key(key)
            assert TR.missing_contribution(key) == \
                JR.missing_contribution(key)
            assert TR.both_dialects(key) == JR.both_dialects(key)


def test_bucketing_classes_are_identical():
    assert TB.MIN_DOC_BUCKET == JB.MIN_DOC_BUCKET
    for n in list(range(0, 70)) + [1000, 1023, 1024, 1025, 65536, 65537]:
        assert TB.next_pow2(n) == JB.next_pow2(n)
        assert TB.next_pow2(n, 128) == JB.next_pow2(n, 128)
        assert TB.bucket_docs(n) == JB.bucket_docs(n)
        for mult in (1, 3, 8):
            assert TB.bucket_queries(n, multiple=mult) == \
                JB.bucket_queries(n, multiple=mult)


@pytest.mark.parametrize("module_name", [
    "repro_torch.core.registry", "repro_torch.core.evaluator",
    "repro_torch.core.trec", "repro_torch.kernels.bucketing",
    "repro_torch.device",
])
def test_port_docstring_examples(module_name):
    results = doctest.testmod(importlib.import_module(module_name))
    assert results.attempted > 0 and results.failed == 0, results
