"""The port's gradient compression and collectives against the JAX
package's, on the CPU.

``train.compression`` bit for bit against ``repro.train.compression``
(int8 values, scale and error state; inputs on exact half-way points pin
round-half-to-even).  One module-scoped gloo group of 4 processes (``python
-m repro_torch.distributed.collectives`` per rank, a ``FileStore`` under
``tmp_path``, a 60 s group timeout, every process killed and the test
failed past ``GROUP_TIMEOUT``) runs ``compressed_psum`` by every method and
``sharded_evaluate``: held against the JAX ``compressed_psum`` under
``jax.vmap(f, axis_name="data")`` (``none`` and ``bf16`` within 1e-6; for
``int8`` the error state bit for bit and the mean within 1 ulp), against
the port's one-process ``compressed_psum_plain``, and against JAX's
``M.aggregate(M.compute_measures(batch))`` within 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measures as JM
from repro.distributed.collectives import compressed_psum as jax_psum
from repro.train import compression as JC

from repro_torch.distributed import collectives as TC
from repro_torch.train import compression as C

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
SEED = 3
GROUP_TIMEOUT = 120  # seconds for the 4 processes, start to exit


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _halfway(rng, n=64):
    """Values on exact half-way points of the int8 grid at scale 1.0
    (absmax 127): ``k + 0.5`` for k in [-60, 60)."""
    x = (rng.integers(-60, 60, n) + 0.5).astype(np.float32)
    x[0] = -127.0
    return x


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    cases = [(rng.standard_normal(40) * rng.uniform(1e-3, 1e3)
              ).astype(np.float32) for _ in range(30)]
    cases.append(_halfway(rng))
    cases.append(np.zeros(5, np.float32))  # absmax below 1e-12
    errors = [(rng.standard_normal(c.shape) * 1e-2).astype(np.float32)
              for c in cases]
    return cases, errors


def test_quantize_int8_bit_for_bit(inputs):
    cases, errors = inputs
    for x, e in zip(cases, errors):
        for err in (None, e):
            want = _np(JC.quantize_int8(jnp.asarray(x), None if err is None
                                        else jnp.asarray(err)))
            got = C.quantize_int8(_t(x), None if err is None else _t(err))
            assert got[0].dtype == torch.int8
            np.testing.assert_array_equal(got[0].numpy(), want[0])
            assert got[1].numpy().tobytes() == want[1].tobytes()
            assert got[2].numpy().tobytes() == want[2].tobytes()
        scale = np.float32(abs(x).max() / 100 + 1e-3)
        want = _np(JC.quantize_int8(jnp.asarray(x), jnp.asarray(e),
                                    jnp.asarray(scale)))
        got = C.quantize_int8(_t(x), _t(e), _t(scale))
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        assert got[2].numpy().tobytes() == want[2].tobytes()


def test_round_half_to_even():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0],
                 np.float32)
    q, s, e = C.quantize_int8(_t(x))
    assert float(s) == 1.0
    assert q.tolist() == [0, 2, 2, 0, -2, -2, 126, 127]
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(JC.quantize_int8(jnp.asarray(x))[0]))
    assert e.tolist() == [0.5, -0.5, 0.5, -0.5, 0.5, -0.5, 0.5, 0.0]


def _tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "emb": {"table": (rng.standard_normal((9, 4)) * 3
                              ).astype(np.float32),
                    "half": _halfway(rng, 8)},
            "b": rng.standard_normal(5).astype(np.float32)}


def _flat_np(tree):
    return TC.flatten(C.tree_map(_t, tree), "")


def test_tree_helpers_bit_for_bit():
    rng = np.random.default_rng(5)
    g = _tree(rng)
    e = _tree(rng)
    tg, te = C.tree_map(_t, g), C.tree_map(_t, e)
    for got, want in ((C.compress_bf16(tg), JC.compress_bf16(g)),
                      (C.decompress_bf16(C.compress_bf16(tg)),
                       JC.decompress_bf16(JC.compress_bf16(g)))):
        got_f = TC.flatten(C.tree_map(lambda x: x.float(), got), "")
        want_f = _flat_np(C.tree_map(lambda x: np.asarray(x, np.float32),
                                     _np(want)))
        assert got_f.keys() == want_f.keys()
        for k in want_f:
            assert got_f[k].tobytes() == want_f[k].tobytes(), k
    assert float(C.local_absmax(tg["w"], te["w"])) == float(
        JC.local_absmax(jnp.asarray(g["w"]), jnp.asarray(e["w"])))
    zeros = C.init_error_state(tg)
    assert all(z.dtype == torch.float32 and not z.any()
               for z in C.tree_leaves(zeros))
    qs, scales, errs = C.compress_grads_int8(tg, te)
    jqs, jscales, jerrs = _np(JC.compress_grads_int8(g, e))
    for got, want in ((qs, jqs), (scales, jscales), (errs, jerrs)):
        gf, wf = TC.flatten(got, ""), _flat_np(want)
        assert gf.keys() == wf.keys()
        for k in wf:
            assert gf[k].tobytes() == wf[k].tobytes(), k
    deq = TC.flatten(C.decompress_grads_int8(qs, scales), "")
    jdeq = _flat_np(_np(JC.decompress_grads_int8(jqs, jscales)))
    for k in jdeq:
        assert deq[k].tobytes() == jdeq[k].tobytes(), k


@pytest.fixture(scope="module")
def group_out(tmp_path_factory):
    """Every rank's results from one gloo group of WORLD processes."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.distributed.collectives",
         "--device", "cpu", "--backend", "gloo", "--seed", str(SEED),
         "--store", str(tmp / "store"), "--rank", str(r),
         "--world-size", str(WORLD), "--out", str(tmp / "out")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the gloo group did not finish in {GROUP_TIMEOUT} s")
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert '"world_size": 4' in outs[0][0]
    return [dict(np.load(tmp / "out" / f"rank{r}.npz"))
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def demo():
    return TC.demo_inputs(SEED, WORLD)


@pytest.fixture(scope="module")
def jax_means(demo):
    """JAX's compressed_psum under ``jax.vmap(..., axis_name="data")``."""
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    grads, errors = stack(demo["grads"]), stack(demo["errors"])
    out = {}
    for method in TC.METHODS:
        def f(g, e, method=method):
            return jax_psum(g, "data", method,
                            e if method == "int8" else None)
        mean, err = _np(jax.vmap(f, axis_name="data")(grads, errors))
        out[method] = (_flat_np(mean),
                       _flat_np(err) if method == "int8" else None)
    return out


@pytest.mark.parametrize("method", TC.METHODS)
def test_compressed_psum_matches_jax_over_a_gloo_group(group_out, jax_means,
                                                       method):
    mean, err = jax_means[method]
    for r, out in enumerate(group_out):
        for k, want in mean.items():
            got = out[f"{method}/mean/{k}"]
            if method == "int8":
                np.testing.assert_array_max_ulp(got, want[r], maxulp=1)
            else:
                np.testing.assert_allclose(got, want[r], rtol=0, atol=1e-6,
                                           err_msg=k)
        if method == "int8":
            for k, want in err.items():
                assert out[f"int8/error/{k}"].tobytes() == \
                    want[r].tobytes(), (r, k)


@pytest.mark.parametrize("method", TC.METHODS)
def test_compressed_psum_matches_its_plain_version(group_out, demo, method):
    grads = [C.tree_map(_t, g) for g in demo["grads"]]
    errors = [C.tree_map(_t, e) for e in demo["errors"]]
    mean, errs = TC.compressed_psum_plain(
        grads, method, errors if method == "int8" else None)
    want = TC.flatten(mean, "")
    for r, out in enumerate(group_out):
        for k, v in want.items():
            got = out[f"{method}/mean/{k}"]
            if method == "int8":
                assert got.tobytes() == v.tobytes(), (r, k)
            else:
                np.testing.assert_allclose(got, v, rtol=0, atol=1e-6)
        if method == "int8":
            for k, v in TC.flatten(errs[r], "").items():
                assert out[f"int8/error/{k}"].tobytes() == v.tobytes()


def test_sharded_evaluate_matches_jax(group_out, demo):
    batch = JM.batch_from_dense(jnp.asarray(demo["scores"]),
                                jnp.asarray(demo["rel"]))
    want = JM.aggregate(JM.compute_measures(
        batch, JM.parse_measures(TC.DEMO_MEASURES)), batch.query_mask)
    assert set(want) == {k[5:] for k in group_out[0] if k.startswith("eval/")}
    for out in group_out:
        for k, v in want.items():
            assert float(out[f"eval/{k}"]) == pytest.approx(float(v),
                                                            abs=1e-5), k
        assert all(out[k] == group_out[0][k] for k in out
                   if k.startswith("eval/"))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown compression"):
        TC.compressed_psum({"w": torch.zeros(2)}, "fp8")
    with pytest.raises(ValueError, match="unknown compression"):
        TC.compressed_psum_plain([{"w": torch.zeros(2)}], "fp8")
