"""The port's EmbeddingBag (kernel B3's plain version) and embedding module
against the JAX package.

On the CPU ``repro_torch.kernels.embedding_bag`` runs its plain version;
these tests hold it against the Pallas kernel run in interpret mode (as
``tests/test_kernels.py`` runs it here) and the embedding module against
``repro.models.embedding``.  Both sum each bag in lookup order, one
rounded multiply and one rounded add per lookup, so the results are
bit-identical (compared with ``==``, so that signed zeros count as equal).
The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.models import embedding as JE
from repro.models import layers as JL

from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import ops, ref
from repro_torch.models import embedding as E
from repro_torch.models import layers as L

from test_torch_measures import single_torch_thread  # noqa: F401


def _bag_inputs(v, e, b, l, seed, sort=True, bags=None):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, e)).astype(np.float32)
    table[0] = -np.abs(table[0])  # a negative row 0: the Pallas seed is -0.0
    seg = (rng.choice(np.asarray(bags, np.int32), l) if bags is not None
           else rng.integers(0, b, l).astype(np.int32))
    if sort:
        seg = np.sort(seg)
    idx = rng.integers(0, v, l).astype(np.int32)
    w = rng.random(l).astype(np.float32)
    w[::5] = 0.0
    return table, idx, seg, w


def _pallas(table, idx, seg, b, w=None):
    """The Pallas kernel (interpret mode); it takes lookups sorted by bag."""
    order = np.argsort(seg, kind="stable")
    args = [jnp.asarray(x[order]) for x in (idx, seg)]
    wj = None if w is None else jnp.asarray(w[order])
    return np.asarray(JOPS.embedding_bag(jnp.asarray(table), *args, b, wj,
                                         interpret=True))


# (V, E, n_bags, L): the three shapes of tests/test_kernels.py, then empty
# bags and unsorted segment ids (L <= 64: one interpreted step per lookup)
CASES = [
    ((30, 8, 4, 20), {}),
    ((100, 32, 10, 64), {}),
    ((11, 16, 3, 7), {}),
    ((20, 10, 9, 30), {"bags": [0, 3, 4, 8]}),
    ((25, 10, 6, 40), {"sort": False}),
]


@pytest.mark.parametrize("shape,kw", CASES)
def test_embedding_bag_plain_matches_pallas_kernel(shape, kw):
    v, e, b, l = shape
    table, idx, seg, w = _bag_inputs(v, e, b, l, seed=v + l, **kw)
    want = _pallas(table, idx, seg, b, w)
    args = [torch.from_numpy(x) for x in (table, idx, seg)]
    got = EB.embedding_bag_plain(*args, b, torch.from_numpy(w)).numpy()
    assert (got == want).all()
    if "bags" in kw:
        empty = np.setdiff1d(np.arange(b), kw["bags"])
        assert (got[empty] == 0).all()


def test_embedding_bag_unweighted_matches_pallas_kernel():
    table, idx, seg, _ = _bag_inputs(30, 8, 4, 20, seed=5)
    want = _pallas(table, idx, seg, 4)
    got = ops.embedding_bag(*[torch.from_numpy(x) for x in (table, idx, seg)],
                            4).numpy()
    assert (got == want).all()


def test_cpu_wrapper_runs_the_plain_version_and_launches_nothing():
    table, idx, seg, w = (torch.from_numpy(x) for x in
                          _bag_inputs(40, 10, 7, 50, seed=9, sort=False))
    before = EB.LAUNCHES
    got = ops.embedding_bag(table, idx, seg, 7, w)
    assert EB.LAUNCHES == before
    assert torch.equal(got, EB.embedding_bag_plain(table, idx, seg, 7, w))
    # the float64 oracle agrees to within f32 rounding of sums of <= 50 terms
    want = ref.embedding_bag_ref(table, idx, seg, 7, w)
    assert torch.allclose(got, want, atol=1e-6, rtol=1e-6)
    # no lookups: every bag is empty
    empty = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(ops.embedding_bag(table, empty, empty, 3),
                       torch.zeros(3, 10))


def test_embedding_bag_rejects_bad_inputs():
    table = torch.zeros((10, 4))
    idx = torch.tensor([1, 2], dtype=torch.int32)
    seg = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx + 9, seg, 2)  # row out of range
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx, seg + 1, 2)  # bag out of range
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx.float(), seg, 2)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx, seg[:1], 2)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx, seg, 2, torch.ones(3))
    with pytest.raises(ValueError):
        EB.embedding_bag(table[0], idx, seg, 2)


# -- the embedding module against repro.models.embedding ----------------------

CFG = E.TableConfig(n_fields=5, vocab_per_field=40, dim=6)
JCFG = JE.TableConfig(n_fields=5, vocab_per_field=40, dim=6)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(21)
    return rng.standard_normal((CFG.total_rows, CFG.dim)).astype(np.float32)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_module_bag_matches_jax(table, combiner, weighted):
    _, idx, seg, w = _bag_inputs(CFG.total_rows, CFG.dim, 9, 60, seed=4,
                                 sort=False)
    w = w if weighted else None
    want = np.asarray(JE.embedding_bag(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(seg), 9,
        weights=None if w is None else jnp.asarray(w), combiner=combiner))
    got = E.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(seg),
        9, weights=None if w is None else torch.from_numpy(w),
        combiner=combiner).numpy()
    assert (got == want).all()


def test_embedding_module_rejects_unknown_combiner(table):
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        E.embedding_bag(torch.from_numpy(table), idx, idx, 1, combiner="max")


def test_field_lookup_matches_jax(table):
    rng = np.random.default_rng(2)
    ids = rng.integers(0, CFG.vocab_per_field, (7, CFG.n_fields)
                       ).astype(np.int32)
    want = np.asarray(JE.field_lookup(jnp.asarray(table), jnp.asarray(ids),
                                      JCFG))
    got = E.field_lookup(torch.from_numpy(table), torch.from_numpy(ids), CFG)
    assert got.shape == (7, CFG.n_fields, CFG.dim)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("field,combiner", [(0, "sum"), (3, "mean")])
def test_multi_hot_lookup_matches_jax(table, field, combiner):
    rng = np.random.default_rng(field)
    ids = rng.integers(0, CFG.vocab_per_field, (6, 8)).astype(np.int32)
    mask = rng.random((6, 8)) < 0.6
    mask[2] = False  # an empty bag
    want = np.asarray(JE.multi_hot_lookup(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask), JCFG, field,
        combiner=combiner))
    got = E.multi_hot_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(mask), CFG, field,
                             combiner=combiner).numpy()
    assert (got == want).all()
    assert (got[2] == 0).all()


def test_init_table_and_dense_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    tab = E.init_table(gen, E.TableConfig(3, 1000, 8), device="cpu")
    assert tab.shape == (3000, 8) and tab.dtype == torch.float32
    assert abs(float(tab.std()) - 0.01) < 0.001
    w = L.dense_init(gen, 400, 300, device="cpu")
    assert w.shape == (400, 300)
    assert abs(float(w.std()) - 400 ** -0.5) < 0.002
    meta = L.dense_init(None, 4, 5, device="meta")
    assert meta.device.type == "meta" and meta.shape == (4, 5)


def test_nonparam_layernorm_matches_jax():
    x = np.random.default_rng(8).standard_normal((4, 5, 50)).astype(
        np.float32) * 3 + 1
    want = np.asarray(JL.nonparam_layernorm(jnp.asarray(x)))
    got = L.nonparam_layernorm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# -- fixed-length bags: every multi-hot field in one call ----------------------


def _mh_inputs(b, f, m, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_per_field, (b, f, m)).astype(np.int32)
    mask = rng.random((b, f, m)) < 0.6
    mask[1, 0] = False  # an empty bag
    return ids, mask


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_multi_hot_lookup_all_matches_jax_field_by_field(table, combiner):
    ids, mask = _mh_inputs(4, 3, 5, seed=31)
    got = E.multi_hot_lookup_all(torch.from_numpy(table),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(mask), CFG,
                                 combiner=combiner).numpy()
    assert got.shape == (4, 3, CFG.dim)
    for f in range(3):
        want = np.asarray(JE.multi_hot_lookup(
            jnp.asarray(table), jnp.asarray(ids[:, f]),
            jnp.asarray(mask[:, f]), JCFG, f, combiner=combiner))
        assert (got[:, f] == want).all(), f
        if combiner == "sum":  # the Pallas kernel on the same bags
            rows = (ids[:, f] + f * CFG.vocab_per_field).reshape(-1)
            segs = np.repeat(np.arange(4, dtype=np.int32), 5)
            w = mask[:, f].reshape(-1).astype(np.float32)
            assert (got[:, f] == _pallas(table, rows, segs, 4, w)).all(), f
    assert (got[1, 0] == 0).all()


@pytest.mark.parametrize("n,m,e,fields,weights", [
    (7, 8, 10, 3, "mask"), (5, 1, 1, 1, "mask"), (6, 3, 33, 2, "none"),
    (0, 8, 10, 3, "mask"), (4, 0, 10, 1, "mask"), (9, 5, 10, 1, "none"),
])
def test_embedding_bag_fixed_plain_matches_the_general_plain_version(
        n, m, e, fields, weights):
    rng = np.random.default_rng(n * 100 + m * 10 + e)
    field_rows = 11
    table = torch.from_numpy(
        rng.standard_normal((fields * field_rows, e)).astype(np.float32))
    table[0] = -table[0].abs()
    table[3, 0] = np.inf  # times a zero weight: NaN, as in the reference
    ids = torch.from_numpy(
        rng.integers(0, field_rows, (n, m)).astype(np.int32))
    w = (torch.from_numpy(rng.random((n, m)) < 0.5) if weights == "mask"
         else None)
    if w is not None and w.numel():
        w.view(-1)[::3] = False
    got = EB.embedding_bag_fixed(table, ids, w, fields, field_rows)
    assert got.shape == (n, e)
    rows = ids.long() + (torch.arange(n) % fields * field_rows)[:, None]
    segs = torch.arange(n)[:, None].expand(n, m).reshape(-1)
    want = EB.embedding_bag_plain(
        table, rows.reshape(-1), segs, n,
        None if w is None else w.reshape(-1).to(torch.float32))
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool((got[~nan] == want[~nan]).all())
    oracle = ref.embedding_bag_fixed_ref(table, ids, w, fields, field_rows)
    assert torch.allclose(got[~nan], oracle[~nan], atol=1e-6, rtol=1e-6)


def test_embedding_bag_fixed_cpu_checks_and_launches_nothing():
    table = torch.zeros((10, 4))
    ids = torch.tensor([[1, 2], [3, 9]], dtype=torch.int32)
    before = EB.LAUNCHES
    ops.embedding_bag_fixed(table, ids)
    assert EB.LAUNCHES == before
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids + 1)  # row 10 out of range
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids - 2)  # negative row
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids, fields=2, field_rows=5)
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids.reshape(-1))
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids, torch.ones(2, 3, dtype=torch.bool))
    with pytest.raises(ValueError):  # float weights: the general entry
        EB.embedding_bag_fixed(table, ids, torch.ones(2, 2))
    with pytest.raises(ValueError):
        EB.embedding_bag_fixed(table, ids.float())
    with pytest.raises(ValueError):
        E.multi_hot_lookup_all(table, ids[None], ids[None] > 0,
                               E.TableConfig(2, 5, 4), combiner="max")
