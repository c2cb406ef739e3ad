"""The CUDA kernels' per-row arithmetic, built for the host with g++.

``csrc/fused_measures.cuh``, ``csrc/bitonic.cuh`` and
``csrc/embedding_bag_bwd.cuh`` hold the math the kernels run (the
per-rank scan step, the cutoff slots, the 64 output columns; the top-k's
key order, admission test, radix select and bitonic sort; B3-bwd's slabs,
chunks and in-order folds).  ``csrc/host_check.cpp`` runs those same
functions rank by rank, key by key and slab by slab on the CPU, with the
top-k kernel's split-and-merge (mode ``topk_split Q D K S STAGE``) and
B3-bwd's grouping (mode ``bag_bwd N M E FIELDS FIELD_ROWS R``), and walks
each fused-measure row chunk by chunk and lane by lane as the kernel's
two regimes do; this test builds
it (no torch headers, about a second) and holds it against the plain
PyTorch versions on small rows.  It is the only check of the kernels'
arithmetic that needs no GPU; the kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import fused_measures as FM
from repro_torch.kernels import topk as TK

from test_torch_cuda import BAG_BWD_CASES, assert_bits_equal, bag_bwd_inputs
from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_measures import assert_columns_match

CSRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "csrc")


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host check cannot be built")
    exe = str(tmp_path_factory.mktemp("host_check") / "host_check")
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-Wall",
                    "-Werror", "-o", exe,
                    os.path.join(CSRC, "host_check.cpp")], check=True)
    return exe


def _fused_inputs(q, d, seed):
    rng = np.random.default_rng(seed)
    rel = rng.integers(-1, 4, (q, d)).astype(np.float32)
    rel[rng.random((q, d)) < 0.5] = 0.0
    judged = (rng.random((q, d)) < 0.6).astype(np.float32)
    judged[rel != 0] = 1.0
    scal = np.zeros((q, FM.SCALAR_WIDTH), np.float32)
    scal[:, 0] = rng.integers(0, 40, q)
    scal[:, 1] = rng.integers(0, 40, q)
    scal[:, 2:12] = rng.random((q, 10)) * 10 + 1
    scal[0, :3] = 0.0  # R = 0 and no ideal gain: the guarded divisions
    return rel, judged, scal


@pytest.mark.parametrize("q,d,level", [
    (4, 1, 1.0), (5, 8, 1.0), (3, 1000, 1.0), (4, 1100, 2.0), (2, 3000, 1.0),
    # the edge between a warp per row and a block per row, and a D that is
    # not a multiple of 4 over three tiles of the block's walk
    (3, 2048, 1.0), (3, 2049, 1.0), (2, 4099, 2.0),
])
def test_fused_row_math_matches_plain(host_check, q, d, level):
    """The kernels' walk (rank-term table; a warp per row up to D = 2,048,
    else a block per row in tiles of 4 chunks, with the carries between
    chunks and tiles; cutoff slots recorded by the lane holding their rank;
    two columns a lane), run by the host check, against the plain version."""
    rel, judged, scal = _fused_inputs(q, d, q * d)
    out = subprocess.run(
        [host_check, "fused", str(q), str(d), repr(level)],
        input=rel.tobytes() + judged.tobytes() + scal.tobytes(),
        capture_output=True, check=True).stdout
    got = np.frombuffer(out, np.float32).reshape(q, FM.OUT_WIDTH)
    want = FM.fused_measures_plain(torch.from_numpy(rel),
                                   torch.from_numpy(judged),
                                   torch.from_numpy(scal), level).numpy()
    cols = {name: i for i, name in enumerate(FM.COLUMNS)}
    assert_columns_match({k: got[:, i] for k, i in cols.items()},
                         {k: want[:, i] for k, i in cols.items()})
    assert not got[:, len(FM.COLUMNS):].any()


@pytest.mark.parametrize("q,d,k", [
    (3, 100, 10), (3, 5, 8), (4, 3000, 1000), (2, 2049, 1000),
    (3, 9000, 128), (2, 5000, 2000),
])
def test_topk_row_math_matches_plain(host_check, q, d, k):
    rng = np.random.default_rng(q + d + k)
    scores = rng.integers(0, 5, (q, d)).astype(np.float32)
    scores[rng.random((q, d)) < 0.1] = -np.inf
    scores[rng.random((q, d)) < 0.1] = -0.0
    scores[0] = rng.standard_normal(d)
    out = subprocess.run([host_check, "topk", str(q), str(d), str(k)],
                         input=scores.tobytes(), capture_output=True,
                         check=True).stdout
    vals = np.frombuffer(out[:q * k * 4], np.float32).reshape(q, k)
    idx = np.frombuffer(out[q * k * 4:], np.int32).reshape(q, k)
    pv, pi = TK.topk_plain(torch.from_numpy(scores), k)
    kk = min(k, d)
    np.testing.assert_array_equal(idx[:, :kk], pi.numpy()[:, :kk])
    np.testing.assert_array_equal(vals[:, :kk], pv.numpy()[:, :kk])
    # short rows: -inf with out-of-range indices, as the Pallas kernel pads
    assert (vals[:, kk:] == -np.inf).all() and (idx[:, kk:] >= d).all()


def _topk_scores(kind, q, d, rng):
    if kind == "ties":  # few values, signed zeros and -inf
        s = rng.integers(0, 5, (q, d)).astype(np.float32)
        s[rng.random((q, d)) < 0.1] = -0.0
        s[rng.random((q, d)) < 0.1] = -np.inf
        s[0] = rng.standard_normal(d)
        return s
    if kind == "ascending":  # every score precedes the running k-th
        return np.tile(np.arange(d, dtype=np.float32), (q, 1))
    if kind == "descending":  # nothing passes after the first k
        return np.tile(np.arange(d, 0, -1).astype(np.float32), (q, 1))
    if kind == "equal":  # all ties: the lowest k columns win
        return np.full((q, d), 2.5, np.float32)
    return rng.standard_normal((q, d)).astype(np.float32)


@pytest.mark.parametrize("kind,q,d,k,splits,stage", [
    ("ties", 3, 4099, 1000, 5, 4096),     # D % 4 != 0, chunks shorter than k
    ("ascending", 2, 9001, 1000, 3, 4096),
    ("descending", 2, 9000, 1000, 2, 4096),
    ("equal", 2, 5000, 300, 4, 512),
    ("ties", 2, 50, 200, 3, 256),          # k > D: padded rows
    ("normal", 2, 3001, 128, 7, 16),       # a select every 8 columns
    ("normal", 3, 10007, 1000, 1, 4096),   # the one-pass launch
    ("ties", 2, 700, 10, 9, 128),          # S does not divide D
])
def test_topk_split_matches_plain(host_check, kind, q, d, k, splits, stage):
    """The filtered per-block top-k (radix selects over the staged keys,
    one final sort) and the split-and-merge of topk.cu, run through
    bitonic.cuh on the host, against topk_plain bit for bit."""
    scores = _topk_scores(kind, q, d, np.random.default_rng(d + k + splits))
    out = subprocess.run(
        [host_check, "topk_split", str(q), str(d), str(k), str(splits),
         str(stage)], input=scores.tobytes(), capture_output=True,
        check=True).stdout
    vals = np.frombuffer(out[:q * k * 4], np.float32).reshape(q, k)
    idx = np.frombuffer(out[q * k * 4:], np.int32).reshape(q, k)
    pv, pi = TK.topk_plain(torch.from_numpy(scores), k)
    kk = min(k, d)
    np.testing.assert_array_equal(idx[:, :kk], pi.numpy()[:, :kk])
    np.testing.assert_array_equal(vals[:, :kk], pv.numpy()[:, :kk])
    assert (vals[:, kk:] == -np.inf).all() and (idx[:, kk:] >= d).all()


def test_topk_split_rejects_a_stage_below_two(host_check):
    scores = np.zeros((1, 10), np.float32)
    res = subprocess.run([host_check, "topk_split", "1", "10", "200", "1",
                          "1"], input=scores.tobytes(), capture_output=True)
    assert res.returncode == 2 and b"STAGE" in res.stderr


def test_make_key_orders_nan_below_every_number_and_padding(host_check):
    """bitonic.cuh's keys: every NaN (either sign, any payload) below
    -inf and every number, NaNs by column among themselves, and above the
    "no element yet" sentinel of rows shorter than k; -0.0 keyed as +0.0.
    The order topk_plain sorts by."""
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFC00123,
                     0x7FFFFFFF, 0xFFFFFFFF], np.uint32).view(np.float32)
    nums = np.array([np.inf, 3.5, 1e-45, 0.0, -0.0, -1e-45, -3.5,
                     -np.finfo(np.float32).max, -np.inf], np.float32)
    v = np.concatenate([nans, nums])
    out = subprocess.run([host_check, "keys", str(len(v))],
                         input=v.tobytes(), capture_output=True,
                         check=True).stdout
    keys = np.frombuffer(out, np.uint64)
    key, empty = keys[:-1], keys[-1]
    high = key >> np.uint64(32)
    n = len(nans)
    assert (high[:n] == high[0]).all()  # one word for every NaN
    assert (key[:n] > empty).all()
    assert key[:n].max() < key[n:].min()  # below every number, -inf too
    assert (np.diff(key[:n].astype(np.int64)) < 0).all()  # by column
    assert (np.diff(high[n:].astype(np.int64)) <= 0).all()
    assert high[n + 3] == high[n + 4]  # -0.0 == +0.0
    # the same order as topk_plain on one row of them
    _, idx = TK.topk_plain(torch.from_numpy(v)[None], len(v))
    np.testing.assert_array_equal(idx[0].numpy(),
                                  np.argsort(-key.astype(np.float64),
                                             kind="stable"))


@pytest.mark.parametrize("q,d,k,splits,stage", [
    (4, 300, 50, 1, 4096),    # one pass
    (4, 3001, 128, 5, 64),    # split rows, a select every 32 keys
    (4, 6, 9, 2, 16),         # rows shorter than k
])
def test_topk_nan_rows_match_plain(host_check, q, d, k, splits, stage):
    """NaN of both signs beside +-inf, an all-NaN row, and short rows
    through the kernel's filter, selects and merge: bit for bit against
    topk_plain (NaN after every number, before the padding)."""
    from test_torch_kernels import nan_rows

    scores = nan_rows(q, d, d + k)
    out = subprocess.run(
        [host_check, "topk_split", str(q), str(d), str(k), str(splits),
         str(stage)], input=scores.tobytes(), capture_output=True,
        check=True).stdout
    vals = np.frombuffer(out[:q * k * 4], np.uint32).reshape(q, k)
    idx = np.frombuffer(out[q * k * 4:], np.int32).reshape(q, k)
    pv, pi = TK.topk_plain(torch.from_numpy(scores), k)
    kk = min(k, d)
    np.testing.assert_array_equal(idx[:, :kk], pi.numpy()[:, :kk])
    np.testing.assert_array_equal(vals[:, :kk],
                                  pv.numpy()[:, :kk].view(np.uint32))
    assert (vals[:, kk:].view(np.float32) == -np.inf).all()
    assert (idx[:, kk:] >= d).all()


# -- B3's backward: embedding_bag_bwd.cuh through the host check ------------


def _run_bag_bwd(host_check, ids, mask, grad, fields, field_rows, r):
    n, m = ids.shape
    e = grad.shape[1]
    ones = np.ones((n, m), bool) if mask is None else mask
    res = subprocess.run(
        [host_check, "bag_bwd", str(n), str(m), str(e), str(fields),
         str(field_rows), str(r)],
        input=ids.tobytes() + ones.astype(np.uint8).tobytes()
        + grad.tobytes(), capture_output=True)
    return res


@pytest.mark.parametrize("n,m,e,fields,field_rows,r,case", [
    (*c[:5], None, c[5]) for c in BAG_BWD_CASES] + [
    # slabs of 8 and 12 rows: rows either side of an edge with V = 291 off
    # a multiple of 8, many slabs, Zipf heads over many slabs, a heavy slab
    (600, 8, 10, 1, 291, 8, "edge8"),
    (5000, 8, 10, 3, 97, 8, "mask"),
    (6000, 1, 10, 39, 700, 12, "zipf"),
    (3000, 8, 10, 1, 97, 8, "repeated"),
    (700, 8, 33, 2, 500, 40, "mask"),
])
def test_bag_bwd_slabs_match_plain(host_check, n, m, e, fields, field_rows,
                                   r, case):
    """B3-bwd's slabs (embedding_bag_bwd.cuh: each slab's lookups from the
    wrapper's grouping, chunks of lookups, each run folded in lookup order
    into a zeroed slab, heavy slabs split by rows among windows of
    lookups, every float of the gradient written once) against
    embedding_bag_fixed_backward_plain on the CPU, bit for bit, NaN where
    it has NaN; at the kernel's slab rows (``EB.slab_rows``) and at
    smaller slabs (``R``)."""
    r = r or EB.slab_rows(e)
    ids, mask, grad = bag_bwd_inputs(n, m, e, fields, field_rows, case,
                                     n + m + e + fields)
    res = _run_bag_bwd(host_check, ids, mask, grad, fields, field_rows, r)
    assert res.returncode == 0, res.stderr
    v = fields * field_rows
    got = torch.from_numpy(np.frombuffer(res.stdout, np.float32).reshape(
        v, e).copy())
    want = EB.embedding_bag_fixed_backward_plain(
        torch.from_numpy(grad), torch.from_numpy(ids),
        None if mask is None else torch.from_numpy(mask), v, fields,
        field_rows)
    assert_bits_equal(got, want)
    if case == "nonfinite":
        assert bool(torch.isnan(want).any())
    if case == "empty":
        assert not bool(got.any())


def test_bag_bwd_out_of_range_row_stops(host_check):
    """A row past V: the kernel traps, the host check exits 3."""
    ids = np.array([[1, 2], [3, 40]], np.int32)  # bag 1 is field 1: row 60
    res = _run_bag_bwd(host_check, ids, None, np.ones((2, 4), np.float32),
                       2, 20, 8)
    assert res.returncode == 3 and b"out of range" in res.stderr


def test_bag_bwd_matches_jax_grad(host_check):
    """The host check's gradient against ``jax.grad`` of the JAX
    package's take, mask and ``segment_sum`` (``repro.models.embedding``,
    all multi-hot fields as one bag list): bit for bit, since XLA's
    scatter on the CPU adds in lookup order too."""
    import jax
    import jax.numpy as jnp

    from repro.models import embedding as JE

    n, f, m, e, vpf = 300, 3, 8, 10, 50
    ids, mask, grad = bag_bwd_inputs(n * f, m, e, f, vpf, "mask", 5)
    cfg = JE.TableConfig(n_fields=f, vocab_per_field=vpf, dim=e)
    table = np.zeros((f * vpf, e), np.float32)

    def loss(t):
        out = jnp.stack([JE.multi_hot_lookup(
            t, jnp.asarray(ids.reshape(n, f, m)[:, k]),
            jnp.asarray(mask.reshape(n, f, m)[:, k]), cfg, k)
            for k in range(f)], axis=1)  # [n, f, e], bag n·f + k
        return jnp.sum(out.reshape(n * f, e) * jnp.asarray(grad))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    res = _run_bag_bwd(host_check, ids, mask, grad, f, vpf, 16)
    assert res.returncode == 0, res.stderr
    got = np.frombuffer(res.stdout, np.float32).reshape(f * vpf, e)
    np.testing.assert_array_equal(got, want)
