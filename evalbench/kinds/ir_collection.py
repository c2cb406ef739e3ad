"""Configurations of kind ``ir_collection``: a test collection and a pool
of score sets drawn from the seed (``data.py``), and the comparison of a
run's outputs with the plain trec_eval reference (``check.py``).

A kind module gives the harness ``inputs(cfg, traffic, seed)``, the
fields an entry's session is built from, and ``readings(cfg, traffic,
inputs, values)``, the numbers that ``correct`` holds against the
traffic's limits."""

from typing import Dict

from evalbench import check, data


def inputs(cfg: dict, traffic: dict, seed: int) -> dict:
    col = data.collection(cfg, seed)
    pool = data.score_pool(cfg, col, seed, int(traffic["score_sets"]))
    return {"col": col, "pool": pool, "qrel": data.qrel_dict(col)}


def readings(cfg: dict, traffic: dict, inputs: dict,
             values: dict) -> Dict[str, float]:
    """The widest gap and the missing values over the kept calls;
    ``values`` maps a call to (its score sets, its output as
    ``session.values`` gives it, or None where the call raised)."""
    ref = check.Reference(inputs["col"], traffic["measures"],
                          cfg["relevance_level"])
    worst = {"max_gap": 0.0, "missing": 0.0}
    for _, (sets, val) in sorted(values.items()):
        if val is None:  # the call raised: nothing of it came back
            worst["missing"] += len(ref.keys) * len(ref.prep.qids)
            continue
        want = [ref.per_query(inputs["pool"][s]) for s in sets]
        r = check.compare(*val, want, ref)
        for k in worst:
            worst[k] = max(worst[k], r[k])
    return worst


def control(session, ctx) -> None:
    """The control in the session's place (``check.put_control``)."""
    check.put_control(session, ctx.col, ctx.pool, ctx.traffic["measures"],
                      ctx.cfg["relevance_level"])
