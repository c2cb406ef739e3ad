"""Training loop with fault tolerance: the port of ``repro.train.trainer``.

Auto-resume from the newest committed checkpoint, an async checkpoint
every ``ckpt_every`` steps, SIGTERM preemption (checkpoint, then stop),
straggler detection, an optional eval at the end.  The loop only
instructs: the step runs on the device and returns its metrics as 0-d
tensors.  It reads them back (one synchronisation) on logged steps only,
so the device runs ahead of the host between two logged steps.  Each
step's time still reaches the straggler monitor, as JAX's does: on the
card a CUDA event is recorded before and after every step and the pairs
are read at the next logged step; on the CPU, where a step returns when
its work is done, the host clock before and after every step.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.train import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    # straggler detection: a step slower than `straggler_factor` × the rolling
    # median is flagged
    straggler_window: int = 20
    straggler_factor: float = 3.0


class StragglerMonitor:
    """Rolling-median step-time outlier detector."""

    def __init__(self, window: int, factor: float):
        self.window = window
        self.factor = factor
        self.times: list = []
        self.flags: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            if dt > self.factor * med:
                self.flags += 1
                return True
        return False


class _StepClock:
    """A mark before and after every step, read in bulk: CUDA events on
    the card (no synchronisation until ``times``), the host clock on the
    CPU."""

    def __init__(self):
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.marks: list = []

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self) -> None:
        self.marks.append(self._now())

    def times(self) -> list:
        """Seconds of each step marked since the last call (one wait for
        the device)."""
        m, self.marks = self.marks, []
        if not self.cuda:
            return [b - a for a, b in zip(m[::2], m[1::2])]
        m[-1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in zip(m[::2], m[1::2])]


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        train_step: Callable,  # (params, opt_state, batch) -> (p, o, metrics)
        params,
        opt_state,
        data_iter: Iterator,
        eval_fn: Optional[Callable] = None,  # (params) -> dict of scalars
    ):
        self.cfg = cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.data_iter = data_iter
        self.eval_fn = eval_fn
        self.step = 0
        self.history: list = []
        self.monitor = StragglerMonitor(cfg.straggler_window,
                                        cfg.straggler_factor)
        self._preempted = False
        self.checkpointer = (
            ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep_ckpts)
            if cfg.ckpt_dir else None)

    # -- fault tolerance ----------------------------------------------------

    def install_preemption_handler(self):
        """Stop at the end of the current step on SIGTERM; returns the
        handler it replaced."""
        def handler(signum, frame):
            self._preempted = True

        return signal.signal(signal.SIGTERM, handler)

    def maybe_resume(self) -> bool:
        """Auto-resume from the latest committed checkpoint, if any."""
        if not self.cfg.ckpt_dir:
            return False
        latest = ckpt_lib.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return False
        state = {"params": self.params, "opt_state": self.opt_state}
        restored, _ = ckpt_lib.restore(self.cfg.ckpt_dir, latest, state)
        self.params = restored["params"]
        self.opt_state = restored["opt_state"]
        self.step = latest
        return True

    def _checkpoint(self) -> None:
        if self.checkpointer is None:
            return
        self.checkpointer.save(
            self.step, {"params": self.params, "opt_state": self.opt_state})

    # -- loop ----------------------------------------------------------------

    def run(self, log_fn: Callable[[str], None] = print) -> Dict:
        last_metrics: Dict = {}
        clock = _StepClock()
        while self.step < self.cfg.total_steps:
            batch = next(self.data_iter)
            clock.mark()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            clock.mark()
            self.step += 1
            if self.step % self.cfg.log_every == 0 or \
                    self.step == self.cfg.total_steps or self._preempted:
                # the one wait for the device in an interval
                times = clock.times()
                for i, dt in enumerate(times):
                    if self.monitor.record(dt):
                        step = self.step - len(times) + 1 + i
                        log_fn(f"[straggler] step {step} took {dt:.3f}s "
                               f"(>{self.cfg.straggler_factor}x rolling "
                               "median)")
                dt = times[-1]
                last_metrics = {k: float(v) for k, v in metrics.items()}
                self.history.append({"step": self.step, "time_s": dt,
                                     **last_metrics})
                msg = " ".join(f"{k}={v:.4f}" for k, v in last_metrics.items())
                log_fn(f"step {self.step}: {msg} ({dt*1e3:.1f} ms)")
            if self.cfg.ckpt_dir and self.step % self.cfg.ckpt_every == 0:
                self._checkpoint()
            if self._preempted:
                log_fn(f"[preemption] SIGTERM at step {self.step}; "
                       "checkpointing and exiting")
                self._checkpoint()
                break
        if self.checkpointer is not None:
            self._checkpoint()
            self.checkpointer.wait()
        if self.eval_fn is not None:
            last_metrics["eval"] = {
                k: float(v) for k, v in self.eval_fn(self.params).items()}
        return last_metrics
