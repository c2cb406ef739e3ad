"""The port's checkpoints and trainer, on the CPU.

* ``train.checkpoint``: a round trip of ``{"params": model, "opt_state":
  OptState}`` (float32 parameters, bfloat16 m, factored v, the int32
  step) restores every leaf bit for bit, into the module's own parameters;
  a ``.tmp`` directory and a step without ``.COMMIT`` are invisible;
  ``garbage_collect`` keeps the newest; a shape or leaf-count mismatch
  raises; ``AsyncCheckpointer`` commits on its thread and raises its
  thread's error on ``wait``.  Across packages: a checkpoint written by
  the JAX package (float32 parameters and state, then bfloat16 m)
  restores into the port leaf for leaf, and one written by the port
  (float32) restores in the JAX package; a bfloat16 leaf is written as
  the same bytes by both, and the JAX package cannot read it back.
* ``train.trainer``: an LM trainer runs, logs, checkpoints every
  ``ckpt_every``, and a new trainer resumes at the same step and ends
  with the same parameters as a run that was never stopped; SIGTERM stops
  it after the step with a checkpoint; the straggler monitor flags an
  outlier step, with a log line at every step and at every fifth (each
  step's time still reaches the monitor between two logged steps).
"""

import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.api import get_arch as j_get_arch
from repro.models import transformer as JT
from repro.train import checkpoint as JC
from repro.train import optimizer as JO

from repro_torch.configs.common import smoke_shape
from repro_torch.data import lm_data as D
from repro_torch.launch.api import get_arch, to_device
from repro_torch.models import transformer as T
from repro_torch.models.convert import (flatten_params, load_jax_opt_state,
                                        load_jax_params)
from repro_torch.train import checkpoint as C
from repro_torch.train import optimizer as O
from repro_torch.train.trainer import StragglerMonitor, TrainConfig, Trainer

from test_torch_measures import single_torch_thread  # noqa: F401

ARCH = "olmo-1b"
B, S = 2, 8


def _model(seed=0):
    cfg = get_arch(ARCH).make_config(True)
    return T.Transformer(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(seed)), cfg


def _state(model, memory_efficient=True, steps=1):
    """An optimizer state with nonzero m and v (``steps`` updates with
    seeded gradients)."""
    cfg = O.OptimizerConfig(momentum_dtype="bfloat16" if memory_efficient
                            else "float32", factored_v=memory_efficient)
    init, update = O.adamw(cfg)
    state = init(model)
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        grads = {n: torch.randn(p.shape, generator=gen)
                 for n, p in model.named_parameters()}
        _, state, _ = update(grads, state, model)
    return state


def _leaves_equal(a, b):
    la, lb = C._named_leaves(a), C._named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), n


# -- checkpoints ---------------------------------------------------------------------


def test_checkpoint_round_trip_restores_every_leaf(tmp_path):
    model, _ = _model()
    state = _state(model)
    assert state.m["embed"].dtype == torch.bfloat16
    assert set(state.v["layers.wq"]) == {"r", "c"}
    tree = {"params": model, "opt_state": state}
    path = C.save(str(tmp_path), 7, tree, extra={"note": "x"})
    assert sorted(os.listdir(path)) == [".COMMIT", "arrays.npz",
                                        "manifest.json"]
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    target_model, _ = _model(seed=5)
    target = {"params": target_model, "opt_state": O.adamw(O.OptimizerConfig(
        momentum_dtype="bfloat16", factored_v=True))[0](target_model)}
    got, extra = C.restore(str(tmp_path), 7, target)
    assert extra == {"note": "x"}
    assert got["params"] is target_model  # restored into its parameters
    for n, p in target_model.named_parameters():
        assert torch.equal(p, want[n]), n
    _leaves_equal(got["opt_state"], state)
    assert isinstance(got["opt_state"], O.OptState)


def test_uncommitted_and_tmp_steps_are_invisible_and_gc_keeps_newest(
        tmp_path):
    d = str(tmp_path)
    assert C.latest_step(d + "/missing") is None
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    for step in (1, 2, 3, 4):
        C.save(d, step, tree)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    os.makedirs(os.path.join(d, "step_00000008"))  # no .COMMIT
    assert C.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        C.restore(d, 8, tree)
    C.garbage_collect(d, keep=2)
    assert C.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000008", "step_00000009.tmp"]


def test_restore_rejects_mismatched_shapes_and_leaf_counts(tmp_path):
    d = str(tmp_path)
    C.save(d, 1, {"a": torch.zeros(3), "b": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        C.restore(d, 1, {"a": torch.zeros(3), "b": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="leaves"):
        C.restore(d, 1, {"a": torch.zeros(3)})


def test_async_checkpointer_commits_and_reports_errors(tmp_path):
    ck = C.AsyncCheckpointer(str(tmp_path / "ck"), keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"w": torch.full((4,), float(step))})
    ck.wait()
    assert ck.last_committed == 3
    assert C.latest_step(str(tmp_path / "ck")) == 3
    assert len(os.listdir(tmp_path / "ck")) == 2
    (tmp_path / "file").write_text("not a directory")
    bad = C.AsyncCheckpointer(str(tmp_path / "file"))
    bad.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()  # the error is raised once


def _jax_tree(memory_efficient):
    jcfg = j_get_arch(ARCH).make_config(True)
    jparams = JT.init_transformer(jax.random.PRNGKey(2), jcfg)
    ocfg = JO.OptimizerConfig(momentum_dtype="bfloat16" if memory_efficient
                              else "float32", factored_v=memory_efficient)
    init, update = JO.adamw(ocfg)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jparams)
    _, jstate, _ = update(grads, init(jparams), jparams)
    return jparams, jstate


@pytest.mark.parametrize("memory_efficient", [False, True])
def test_jax_written_checkpoint_restores_in_the_port(tmp_path,
                                                     memory_efficient):
    jparams, jstate = _jax_tree(memory_efficient)
    JC.save(str(tmp_path), 3, {"params": jparams, "opt_state": jstate})
    model, _ = _model(seed=9)
    state = O.adamw(O.OptimizerConfig(
        momentum_dtype="bfloat16" if memory_efficient else "float32",
        factored_v=memory_efficient))[0](model)
    got, _ = C.restore(str(tmp_path), 3,
                       {"params": model, "opt_state": state})
    want = flatten_params(jax.tree.map(np.asarray, jparams))
    for n, p in model.named_parameters():
        assert p.detach().numpy().tobytes() == want[n].tobytes(), n
    _leaves_equal(got["opt_state"], load_jax_opt_state(
        jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jstate)))


def test_port_written_checkpoint_restores_in_jax(tmp_path):
    jparams, jstate = _jax_tree(False)
    model, _ = _model()
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    state = load_jax_opt_state(jax.tree.map(np.asarray, jparams),
                               jax.tree.map(np.asarray, jstate))
    with torch.no_grad():  # values the JAX tree does not hold
        for p in model.parameters():
            p.mul_(1.5)
        state.m["embed"].add_(0.25)
    C.save(str(tmp_path), 4, {"params": model, "opt_state": state})
    target = {"params": jparams, "opt_state": jstate}
    got, _ = JC.restore(str(tmp_path), 4, target)
    want = dict(model.named_parameters())
    for n, leaf in flatten_params(jax.tree.map(np.asarray,
                                               got["params"])).items():
        assert leaf.tobytes() == want[n].detach().numpy().tobytes(), n
    m = got["opt_state"].m
    names = O.leaf_order(want)
    for n, mi in zip(names, m):
        assert np.asarray(mi).tobytes() == state.m[n].numpy().tobytes(), n
    assert int(got["opt_state"].step) == int(state.step) == 1


def test_bfloat16_leaves_are_written_as_jax_writes_them(tmp_path):
    values = np.array([0.0, -1.5, 3.140625, 1e-3, -2e30], np.float32)
    JC.save(str(tmp_path / "jax"), 1, {"x": jnp.asarray(values,
                                                        jnp.bfloat16)})
    C.save(str(tmp_path / "port"), 1,
           {"x": torch.from_numpy(values).to(torch.bfloat16)})
    j = np.load(tmp_path / "jax" / "step_00000001" / "arrays.npz")
    p = np.load(tmp_path / "port" / "step_00000001" / "arrays.npz")
    assert j["leaf_00000"].dtype == p["leaf_00000"].dtype
    assert j["leaf_00000"].tobytes() == p["leaf_00000"].tobytes()
    got, _ = C.restore(str(tmp_path / "jax"), 1,
                       {"x": torch.zeros(5, dtype=torch.bfloat16)})
    assert torch.equal(got["x"],
                       torch.from_numpy(values).to(torch.bfloat16))
    # the reference cannot read its own bfloat16 leaves back (no cast
    # from |V2), so neither package's bfloat16 checkpoint restores there
    with pytest.raises(ValueError, match="cast"):
        JC.restore(str(tmp_path / "jax"), 1,
                   {"x": jnp.zeros(5, jnp.bfloat16)})


# -- the trainer -------------------------------------------------------------------


def _lm_trainer(ckpt_dir, total, model=None, log_every=2, ckpt_every=2):
    arch = get_arch(ARCH)
    if model is None:
        model, cfg = _model()
    cfg = model.cfg
    shape = smoke_shape(arch.shapes["train_4k"], seq_len=S, global_batch=B)
    bundle = arch.make_step(cfg, shape, device="cpu")
    data = D.MarkovLM(D.LMDataConfig(cfg.vocab_size, S, B))

    def step(m, o, batch):
        return bundle.step_fn(m, o, to_device(batch, "cpu"))

    trainer = Trainer(TrainConfig(total_steps=total, log_every=log_every,
                                  ckpt_every=ckpt_every, ckpt_dir=ckpt_dir),
                      step, model, bundle.init_opt(model), data.iterator())
    return trainer, data


def test_trainer_runs_checkpoints_and_resumes_where_it_stopped(tmp_path):
    straight, _ = _lm_trainer(None, 6)
    logs = []
    out = straight.run(log_fn=logs.append)
    assert [h["step"] for h in straight.history] == [2, 4, 6]
    assert np.isfinite(out["loss"]) and 0 < out["recip_rank"] <= 1
    assert len(logs) == 3 and logs[-1].startswith("step 6: loss=")

    d = str(tmp_path / "ck")
    first, _ = _lm_trainer(d, 4, ckpt_every=2)
    first.run(log_fn=lambda _: None)
    assert C.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    model, _ = _model(seed=3)  # other weights, replaced on resume
    second, data = _lm_trainer(d, 6, model=model)
    assert second.maybe_resume() and second.step == 4
    assert int(second.opt_state.step) == 4
    second.data_iter = data.iterator(start_step=second.step)
    second.run(log_fn=lambda _: None)
    assert second.step == 6 and C.latest_step(d) == 6
    want = dict(straight.params.named_parameters())
    for n, p in second.params.named_parameters():
        assert torch.equal(p, want[n]), n


def test_sigterm_stops_the_trainer_with_a_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    trainer, _ = _lm_trainer(d, 50, log_every=100, ckpt_every=100)
    inner = trainer.train_step

    def step(m, o, batch):
        out = inner(m, o, batch)
        if int(out[1].step) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step
    previous = trainer.install_preemption_handler()
    try:
        logs = []
        trainer.run(log_fn=logs.append)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert trainer.step == 3
    assert any(s.startswith("[preemption] SIGTERM at step 3") for s in logs)
    assert C.latest_step(d) == 3
    model, _ = _model(seed=4)
    resumed, _ = _lm_trainer(d, 50, model=model)
    assert resumed.maybe_resume() and resumed.step == 3
    want = dict(trainer.params.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, want[n]), n


def test_straggler_monitor_flags_an_outlier():
    mon = StragglerMonitor(window=20, factor=3.0)
    assert not any(mon.record(0.01) for _ in range(6))
    assert mon.record(0.05) and mon.flags == 1
    assert not mon.record(0.011)


@pytest.mark.parametrize("log_every", [1, 5])
def test_trainer_flags_a_slow_step_between_logged_steps(log_every):
    def step(params, opt_state, batch):  # 20 ms a step, one of 300 ms
        time.sleep(0.3 if batch == 7 else 0.02)
        return params, opt_state, {"loss": torch.tensor(float(batch))}

    def data():
        yield from range(100)

    trainer = Trainer(TrainConfig(total_steps=10, log_every=log_every),
                      step, {}, {}, data())
    logs = []
    out = trainer.run(log_fn=logs.append)
    assert out == {"loss": 9.0}
    assert trainer.monitor.flags == 1
    assert [s for s in logs if s.startswith("[straggler]")] == [
        s for s in logs if s.startswith("[straggler] step 8 ")]
    assert [h["step"] for h in trainer.history] == list(
        range(log_every, 11, log_every))
    # a logged step's time is its own, as in JAX's history
    assert [h["time_s"] >= 0.3 for h in trainer.history] == [
        h["step"] == 8 for h in trainer.history]
    assert all(h["time_s"] >= 0.02 for h in trainer.history)
