"""Model-parallel serving on a gloo group of 4 CPU processes, mesh (2, 2),
against the unsharded port steps and the JAX package.

One module-scoped spawn of ``python -m repro_torch.launch.sharded_serve``
per rank (a ``FileStore`` under ``tmp_path``, a 60 s group timeout, every
process killed and the test failed past ``GROUP_TIMEOUT``) runs the
smoke cases (``sharded_serve.SMOKE_CASES``): olmo, qwen3-moe and arctic
``prefill`` and 4 ``decode`` steps with the cache sequence-sharded
(arctic's and qwen3's decode in FSDP ``activation`` mode), a phi3 variant
whose 3 query heads do not split over the 2 ``model`` ranks, arctic's
MoE block alone in ``gather`` and ``activation`` modes, the
vocab-parallel lookups, candidate-sharded retrieval with ties and a NaN,
xDeepFM ``serve_bulk`` with the table row-sharded, and the eval arch.
The LM weights are given to the ranks (``--weights``).  Each sharded
result is held against the same step without a mesh in the same
process (the LM prefill on each data shard's rows, as JAX's capacity is
a shard's), and against JAX: the LM steps
(``JT.prefill`` per data shard, ``JT.decode_step``), the MoE against
``moe_apply_local`` on each data shard (``activation`` mode routes the
tokens gathered over ``data``: all of them), the lookups against
``field_lookup`` / ``multi_hot_lookup``.  The weights are seeded arrays in
JAX's layout, carried into both.  Indices and counts exact, the rest
atol = rtol = 2e-4.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.launch.api import get_arch as j_get_arch
from repro.models import embedding as JE
from repro.models import moe as JMoE
from repro.models import transformer as JT

from repro_torch.launch import sharded_serve as SS

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD, MESH = 4, "2x2"
N_DATA = 2
GROUP_TIMEOUT = 120  # seconds for the 4 processes, start to exit
TOL = 2e-4
LM_CASES = [c[3:] for c in SS.SMOKE_CASES if c.startswith("lm:")]


def _jax_config(arg):
    name, *fields = arg.split(":")
    over = {k: int(v) for k, v in (f.split("=") for f in fields)}
    import dataclasses

    return dataclasses.replace(j_get_arch(name).make_config(True), **over)


def _nest(flat):
    """``{"layers.wq": a}`` → ``{"layers": {"wq": a}}`` (a JAX tree)."""
    out = {}
    for name, a in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded weights of each LM case in JAX's layout, as ``--weights``
    files, and as JAX trees."""
    from repro_torch.models import transformer as T

    out = tmp_path_factory.mktemp("weights")
    rng = np.random.default_rng(3)
    params = {}
    for arg in LM_CASES:
        _, cfg, tag = SS.lm_config(arg, "smoke")
        flat = {}
        for name, p in T.Transformer(cfg, device="meta").named_parameters():
            x = rng.standard_normal(tuple(p.shape))
            if "norm" in name:
                x = 1.0 + 0.1 * x
            else:
                x *= 0.02 if name == "embed" else p.shape[-2] ** -0.5
            flat[name] = x.astype(np.float32)
        np.savez(out / f"{tag}.npz", **flat)
        params[arg] = _nest(flat)
    return out, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    """Every rank's saved results from one gloo group of WORLD processes."""
    tmp = tmp_path_factory.mktemp("mp")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sharded_serve",
         "--device", "cpu", "--backend", "gloo", "--mesh", MESH,
         "--store", str(tmp / "store"), "--rank", str(r),
         "--world-size", str(WORLD), "--weights", str(weights[0]),
         "--out", str(tmp / "out")],
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
    return [dict(np.load(tmp / "out" / f"rank{r}.npz"))
            for r in range(WORLD)]


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _sub(out, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in out.items() if k.startswith(prefix + "/")}


def test_every_rank_returns_the_same_results(ranks):
    """Each step returns the unsharded step's values on every rank."""
    for r in range(1, WORLD):
        assert ranks[r].keys() == ranks[0].keys()
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(ranks[r][k], v, err_msg=k)


@pytest.mark.parametrize("arg", LM_CASES)
def test_lm_prefill_and_decode_match_unsharded(ranks, arg):
    out = ranks[0]
    got, want = _sub(out, f"lm:{arg}/got"), _sub(out, f"lm:{arg}/want")
    assert got.keys() == want.keys() and "decode3" in got
    for k in got:
        if k.startswith("metrics"):  # from the gold ranks: exact
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            _close(got[k], want[k], f"{arg} {k}")


@pytest.fixture(scope="module")
def jax_lm(ranks, weights):
    """JAX's prefill on each data shard's rows, then decode on all."""
    out = {}
    for arg in LM_CASES:
        jcfg = _jax_config(arg)
        jp = weights[1][arg]
        inputs = _sub(ranks[0], f"lm:{arg}/inputs")
        tokens, nxt = inputs["tokens"], inputs["next"]
        b, s = tokens.shape
        per = b // N_DATA
        max_seq = s + SS.DECODE_STEPS
        prefill = jax.jit(lambda p, t, jcfg=jcfg: JT.prefill(
            p, t, jcfg, max_seq=max_seq))
        parts = [prefill(jp, jnp.asarray(tokens[i * per:(i + 1) * per]))
                 for i in range(N_DATA)]
        res = {"prefill": np.concatenate([np.asarray(p[0]) for p in parts])}
        cache = {k: jnp.concatenate([p[1][k] for p in parts], 1)
                 for k in ("k", "v")}
        decode = jax.jit(JT.decode_step, static_argnums=4)
        for t in range(SS.DECODE_STEPS):
            logits, cache = decode(jp, cache, jnp.asarray(nxt[t]), s + t,
                                   jcfg)
            res[f"decode{t}"] = np.asarray(logits)
        res["cache_k"], res["cache_v"] = (np.asarray(cache["k"]),
                                          np.asarray(cache["v"]))
        out[arg] = res
    return out


@pytest.mark.parametrize("arg", LM_CASES)
def test_lm_prefill_and_decode_match_jax(ranks, jax_lm, arg):
    got = _sub(ranks[0], f"lm:{arg}/got")
    for k, want in jax_lm[arg].items():
        _close(got[k], want, f"{arg} {k} vs JAX")


def test_head_cut_case_splits_heads_unevenly():
    _, cfg, _ = SS.lm_config(LM_CASES[-1], "smoke")
    assert cfg.n_heads % 2 and cfg.n_heads // cfg.n_kv_heads == 3


@pytest.mark.parametrize("mode", ("gather", "activation"))
def test_moe_matches_jax_moe_apply_local_per_data_shard(ranks, weights,
                                                         mode):
    arg = "arctic-480b"
    jcfg = _jax_config(arg)
    lp = {k: v[0] for k, v in weights[1][arg]["layers"].items()}
    params = {"router": lp["router"], "w_gate": lp["moe_gate"],
              "w_up": lp["moe_up"], "w_down": lp["moe_down"]}
    x = _sub(ranks[0], f"moe:{arg}/inputs")["x"]
    moe = jax.jit(lambda x, p: JMoE.moe_apply_local(x, p, jcfg.moe,
                                                    model_axis=None))
    if mode == "gather":  # capacity from a data shard's tokens
        t = SS.MOE_TOKENS
        want = np.concatenate([np.asarray(moe(jnp.asarray(
            x[i * t:(i + 1) * t]), params)) for i in range(N_DATA)])
    else:  # the tokens gathered over the FSDP axis: every data rank's
        want = np.asarray(moe(jnp.asarray(x), params))
    got = ranks[0][f"moe:{arg}/got/{mode}"]
    _close(got, want, f"moe {mode} vs JAX")
    _close(got, ranks[0][f"moe:{arg}/want/{mode}"], f"moe {mode}")


@pytest.mark.parametrize("what", ("field", "sum", "mean"))
def test_vocab_parallel_lookup(ranks, what):
    from repro_torch.launch.api import get_arch

    out = ranks[0]
    _close(out[f"lookup/got/{what}"], out[f"lookup/want/{what}"], what)
    inputs = _sub(out, "lookup/inputs")
    cfg = get_arch("xdeepfm").make_config(True)
    table = jnp.asarray(inputs["table"])
    if what == "field":
        want = JE.field_lookup(table, jnp.asarray(inputs["ids"]), cfg.table)
    else:
        want = jnp.stack([JE.multi_hot_lookup(
            table, jnp.asarray(inputs["mh_ids"][:, f]),
            jnp.asarray(inputs["mh_mask"][:, f]), cfg.table, f, what)
            for f in range(cfg.n_multi_hot)], 1)
    _close(out[f"lookup/got/{what}"], np.asarray(want), f"{what} vs JAX")


def test_candidate_sharded_retrieval_is_the_unsharded_top_k(ranks):
    out = ranks[0]
    got, want = (_sub(out, "retrieval:sasrec/got"),
                 _sub(out, "retrieval:sasrec/want"))
    values, idx = got["0"], got["1"]
    np.testing.assert_array_equal(idx, want["1"])
    assert values.tobytes() == want["0"].tobytes()
    # NaN last (in index order), ties to the lower index
    nan = np.isnan(values[0])
    assert nan.any() and not nan[:np.argmax(nan)].any()
    assert nan[np.argmax(nan):].all()
    assert (np.diff(idx[0][nan]) > 0).all()
    cand = _sub(out, "retrieval:sasrec/inputs")["cand"]
    finite = values[0][~nan]
    for v in np.unique(finite[np.unique(finite, return_counts=True)[1][
            np.searchsorted(np.unique(finite), finite)] > 1]):
        tied = idx[0][:len(finite)][finite == v]
        assert (np.diff(tied) > 0).all() and len(set(cand[tied])) == 1
    for k in ("ndcg_cut_10", "recip_rank", "success_10"):
        assert got[f"2/{k}"] == want[f"2/{k}"], k


def test_serve_bulk_with_the_table_row_sharded(ranks):
    out = ranks[0]
    _close(out["serve:xdeepfm/got"], out["serve:xdeepfm/want"], "scores")


def test_eval_arch_on_the_mesh(ranks):
    """Its unsharded aggregates are held against JAX's in
    ``test_torch_paper_arch.py``."""
    out = ranks[0]
    got, want = _sub(out, "eval/got"), _sub(out, "eval/want")
    assert got.keys() == want.keys() and "map" in got
    for k in got:
        _close(got[k], want[k], k)


def test_full_tensor_gathers_uneven_blocks(ranks):
    np.testing.assert_array_equal(ranks[0]["gather/got"],
                                  ranks[0]["gather/want"])
