"""The ``pytrec-eval`` arch (the paper's own evaluator) against the JAX
package's, on the CPU.

``get_arch("pytrec-eval").make_step(cfg, shape, device)`` in the port must
describe the batch the JAX step takes (shapes and dtypes, the JAX mesh
padding aside) and, on the same numpy batch, return what ``jax.jit`` of
the JAX step returns: every measure's corpus mean, for both engines
(``sorted`` and ``ranked``).  The per-query columns behind those means are
held exactly (count columns) and within 2e-4 (the rest) for the sorted
engine; the port's ranked engine divides where the sorted engine divides,
so its count columns are bit-identical to the sorted engine's, while the
JAX ranked engine's ``Rprec`` is a last bit away from its own sorted
engine: against it every column is held within 2e-4, as
``tests/test_torch_ranked.py`` holds the engines.  A mean is a float32 sum
over the queries, which XLA and torch add in their own order, so a count
column's mean is held to that sum's rounding bound, Q·2^-24 relative, and
the rest to 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as JM
from repro.core import ranked as JRK
from repro.launch.api import ShapeSpec as JShapeSpec
from repro.launch.api import get_arch as j_get_arch

from repro_torch.configs import pytrec_paper as P
from repro_torch.core import measures as M
from repro_torch.core import ranked as RK
from repro_torch.launch.api import ShapeSpec, TensorSpec, get_arch

from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_measures import (assert_columns_match, is_exact,
                                 random_fields)

#: a smoke-sized cell: 8 queries x 64 docs, 16 judged
SMOKE = (("n_queries", 8), ("n_docs", 64), ("n_judged", 16))
ENGINES = ("sorted", "ranked")

_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.bool: np.bool_}


@pytest.fixture(scope="module")
def fields():
    """8 x 64 with at most 16 judged documents a query, so a RankedBatch
    of J = 16 holds every judged one and the two engines see the same
    run."""
    f = random_fields(31, q=8, d=64, j=16)
    f["scores"] = f["scores"].astype(np.float32)
    f["judged"] &= np.cumsum(f["judged"], axis=1) <= 16
    f["rel"] = np.where(f["judged"], f["rel"], 0.0).astype(np.float32)
    return f


def _assert_means_match(got, want, q, exact=True):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        tol = ((q * 2.0**-24 * abs(w), 0.0) if exact and is_exact(k)
               else (2e-4, 2e-4))
        assert abs(g - w) <= tol[0] + tol[1] * abs(w), (k, g, w)


def _per_query(engine, batch, jax_pkg):
    measures = (JM if jax_pkg else M).parse_measures(P.MEASURES)
    if engine == "ranked":
        fn = JRK.compute_measures_ranked if jax_pkg else \
            RK.compute_measures_ranked
    else:
        fn = JM.compute_measures if jax_pkg else M.compute_measures
    if jax_pkg:
        return {k: np.asarray(v)
                for k, v in jax.jit(lambda b: fn(b, measures))(batch).items()}
    return {k: v.numpy() for k, v in fn(batch, measures).items()}


def _cfgs(engine):
    return (dataclasses.replace(P.make_config(True), engine=engine),
            dataclasses.replace(j_get_arch("pytrec-eval").make_config(True),
                                engine=engine))


def _batches(engine, fields, j):
    """The same numpy batch for both packages: an EvalBatch, or the
    RankedBatch each package's own builder makes from it."""
    tb = M.batch_from_numpy(fields, "cpu")
    jb = JM.EvalBatch(**{k: jnp.asarray(v) for k, v in fields.items()})
    if engine == "ranked":
        return RK.from_eval_batch(tb, j), JRK.from_eval_batch(jb, j)
    return tb, jb


def test_registry_has_the_eval_arch():
    arch = get_arch("pytrec-eval")
    assert arch.family == "eval"
    theirs = j_get_arch("pytrec-eval")
    assert {k: (v.kind, v.meta) for k, v in arch.shapes.items()} == \
        {k: (v.kind, v.meta) for k, v in theirs.shapes.items()}
    assert P.MEASURES == j_get_arch("pytrec-eval").make_step.__globals__[
        "MEASURES"]
    assert arch.make_config(False) == P.EvalConfig("pytrec-eval")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("shape", ["eval_10k_1k", "eval_1k_64k"])
def test_arg_specs_describe_the_jax_batch(engine, shape):
    """Field by field the JAX step's abstract batch (no mesh, so no
    padding there either), as TensorSpecs on the requested device."""
    cfg, jcfg = _cfgs(engine)
    bundle = get_arch("pytrec-eval").make_step(
        cfg, get_arch("pytrec-eval").shapes[shape], device="cpu")
    jbundle = j_get_arch("pytrec-eval").make_step(
        jcfg, j_get_arch("pytrec-eval").shapes[shape], None)
    (got,), (want,) = bundle.arg_specs, jbundle.arg_specs
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert isinstance(g, TensorSpec), name
        assert g.shape == tuple(w.shape), name
        assert np.dtype(_NP[g.dtype]) == np.dtype(w.dtype), name
    assert bundle.device == torch.device("cpu")


@pytest.mark.parametrize("engine", ENGINES)
def test_step_matches_jax_jit(engine, fields):
    cfg, jcfg = _cfgs(engine)
    shape = ShapeSpec("smoke", "serve", SMOKE)
    bundle = get_arch("pytrec-eval").make_step(cfg, shape, device="cpu")
    jbundle = j_get_arch("pytrec-eval").make_step(
        jcfg, JShapeSpec("smoke", "serve", SMOKE), None)
    tb, jb = _batches(engine, fields, 16)
    for name, spec, t in zip(tb._fields, bundle.arg_specs[0], tb):
        assert (tuple(t.shape), t.dtype) == tuple(spec), name
    got = bundle.step_fn(tb)
    want = jax.jit(jbundle.step_fn)(jb)
    assert all(v.dim() == 0 for v in got.values())
    _assert_means_match(got, want, 8, exact=engine == "sorted")
    mine, theirs = _per_query(engine, tb, False), _per_query(engine, jb,
                                                              True)
    if engine == "sorted":
        assert_columns_match(mine, theirs)
    else:
        for k, w in theirs.items():
            np.testing.assert_allclose(mine[k], w, atol=2e-4, rtol=2e-4,
                                       err_msg=k)


def test_engines_agree_with_each_other_and_the_per_query_mean(fields):
    """The two engines on one batch (per-query counts exact, the rest at
    2e-4; their means as above), and the sorted step's means equal the
    mean of its per-query columns."""
    shape = ShapeSpec("smoke", "serve", SMOKE)
    out = {}
    for engine in ENGINES:
        cfg, _ = _cfgs(engine)
        step = get_arch("pytrec-eval").make_step(cfg, shape,
                                                 device="cpu").step_fn
        batch = _batches(engine, fields, 16)[0]
        out[engine] = step(batch)
        out[engine + "_per_query"] = _per_query(engine, batch, False)
    assert_columns_match(out["ranked_per_query"], out["sorted_per_query"])
    _assert_means_match(out["ranked"], out["sorted"], 8)
    per_q = M.compute_measures(M.batch_from_numpy(fields, "cpu"),
                               M.parse_measures(P.MEASURES))
    qm = fields["query_mask"]
    for k, v in out["sorted"].items():
        assert float(v) == pytest.approx(
            float(per_q[k].numpy()[qm].mean()), abs=2e-4, rel=2e-4), k


def test_a_config_imported_alone_does_not_hide_the_others():
    """Importing one config module registers only its arch; the registry
    still lists every arch (it once stopped loading at a non-empty
    registry)."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    code = ("from repro_torch.configs import pytrec_paper\n"
            "from repro_torch.launch.api import get_arch, list_archs\n"
            "assert list_archs() == ['arctic-480b', 'autoint', "
            "'gatedgcn', 'mind', 'nemotron-4-15b', 'olmo-1b', "
            "'phi3-medium-14b', 'pytrec-eval', 'qwen3-moe-235b-a22b', "
            "'sasrec', 'xdeepfm'], list_archs()\n"
            "get_arch('xdeepfm')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_step_defaults_to_cuda_and_rejects_unknown_engines(monkeypatch):
    arch = get_arch("pytrec-eval")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        arch.make_step(arch.make_config(False), arch.shapes["eval_10k_1k"])
    bad = dataclasses.replace(arch.make_config(True), engine="fused")
    with pytest.raises(ValueError, match="engine"):
        arch.make_step(bad, arch.shapes["eval_10k_1k"], device="cpu")
