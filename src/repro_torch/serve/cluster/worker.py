"""One cluster worker: a ``python -m repro_torch.serve`` process + client.

:class:`WorkerProcess` owns exactly the *mechanics* of one worker
generation — spawn the subprocess on an ephemeral TCP port, parse the
``serving on host:port`` banner off its stderr, connect an
:class:`~repro_torch.client.aio.AsyncEvalClient` and confirm readiness with the
lightweight ``ping`` op, and later stop it gracefully (SIGTERM → the
worker's own drain machinery finishes in-flight batches → bounded wait →
SIGKILL fallback).  Restart *policy* (backoff, health checks, journal
replay) lives in :class:`~repro_torch.serve.cluster.router.Router`, which calls
:meth:`start` again for each new generation.

Each generation gets a fresh port and a fresh client: the old client's
pending futures fail with ``ConnectionLostError`` the moment the process
dies, which is what unblocks the router's retry path.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import os
import signal
import sys
from typing import Deque, List, Optional, Sequence, Tuple

import repro_torch
from repro_torch.client.aio import AsyncEvalClient
from repro_torch.serve.wire import DEFAULT_FRAME_LIMIT

#: directory that makes ``import repro_torch`` work in the child, whatever
#: the parent's cwd is — prepended to the child's PYTHONPATH
_SRC = os.path.dirname(os.path.dirname(os.path.abspath(
    repro_torch.__file__)))

_BANNER = "serving on "


class WorkerStartupError(ConnectionError):
    """The worker subprocess died or hung before announcing readiness."""


class WorkerProcess:
    """Lifecycle of one worker slot across process generations.

    ``extra_args`` are appended to the ``python -m repro_torch.serve --tcp
    127.0.0.1:0`` command line (measure flags, ``--window-ms``, ...),
    ``--device cuda`` or ``--device cpu`` among them: the worker's device
    reaches it there like every other flag, and the server's own default
    is CUDA.
    ``frame_limit`` is the *router's* frame limit; the worker's server and
    this side's client both get a little headroom on top of it, because
    forwarded frames carry a spliced-on internal request id.

    ``wrap_endpoint`` is an async hook ``(name, host, port) -> (host,
    port)`` called once per generation, after the banner is parsed and
    before the client connects — the chaos harness uses it to interpose a
    fault-injecting TCP proxy between router and worker.
    """

    def __init__(self, name: str, *, extra_args: Sequence[str] = (),
                 python: str = sys.executable,
                 frame_limit: int = DEFAULT_FRAME_LIMIT,
                 env: Optional[dict] = None, wrap_endpoint=None):
        self.name = name
        self._extra = [str(a) for a in extra_args]
        self._python = python
        self._frame_limit = int(frame_limit) + 4096  # id-splice headroom
        self._env = env
        self._wrap_endpoint = wrap_endpoint
        self.proc: Optional[asyncio.subprocess.Process] = None
        self.client: Optional[AsyncEvalClient] = None
        self.host: Optional[str] = None
        self.port: Optional[int] = None
        self.generation = 0
        #: last stderr lines from the current generation, for diagnostics
        self.last_stderr: Deque[str] = collections.deque(maxlen=40)
        self._stderr_task: Optional[asyncio.Task] = None

    # -- lifecycle -----------------------------------------------------------

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.returncode is None

    def _argv(self) -> List[str]:
        return [self._python, "-m", "repro_torch.serve",
                "--tcp", "127.0.0.1:0",
                "--max-frame-mb", str(self._frame_limit / 2**20),
                *self._extra]

    def _child_env(self) -> dict:
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        env["PYTHONPATH"] = _SRC + os.pathsep + env.get("PYTHONPATH", "")
        return env

    async def start(self, *, ready_timeout: float = 30.0) -> None:
        """Spawn a new generation and block until it answers ``ping``.

        ``ready_timeout`` bounds the banner and the ``ping`` each; the
        default covers a generation's torch import and, on the card, its
        CUDA context (seconds each).
        """
        assert not self.alive, f"worker {self.name} is already running"
        self.generation += 1
        self.last_stderr.clear()
        if self._stderr_task is not None:
            self._stderr_task.cancel()
            self._stderr_task = None
        self.proc = await asyncio.create_subprocess_exec(
            *self._argv(), stdin=asyncio.subprocess.DEVNULL,
            stderr=asyncio.subprocess.PIPE, env=self._child_env())
        try:
            self.host, self.port = await asyncio.wait_for(
                self._await_banner(), ready_timeout)
            if self._wrap_endpoint is not None:
                self.host, self.port = await self._wrap_endpoint(
                    self.name, self.host, self.port)
            # keep stderr flowing so the pipe never fills and the last
            # lines are available when the process dies
            self._stderr_task = asyncio.get_running_loop().create_task(
                self._drain_stderr())
            self.client = await AsyncEvalClient.connect(
                self.host, self.port, retries=0,
                frame_limit=self._frame_limit)
            pong = await asyncio.wait_for(self.client.ping(), ready_timeout)
            assert pong == "pong", pong
        except BaseException as exc:
            self.kill()
            with contextlib.suppress(Exception):
                await self.proc.wait()
            if self.client is not None:
                with contextlib.suppress(Exception):
                    await self.client.aclose()
                self.client = None
            if isinstance(exc, (asyncio.TimeoutError, ConnectionError,
                                OSError)):
                raise WorkerStartupError(
                    f"worker {self.name} failed to become ready: "
                    f"{type(exc).__name__}: {exc}; stderr: "
                    f"{list(self.last_stderr)[-5:]}") from exc
            raise

    async def _await_banner(self) -> Tuple[str, int]:
        while True:
            line = await self.proc.stderr.readline()
            if not line:
                rc = await self.proc.wait()
                raise WorkerStartupError(
                    f"worker {self.name} exited (rc={rc}) before ready; "
                    f"stderr: {list(self.last_stderr)[-5:]}")
            text = line.decode("utf-8", "replace").strip()
            if text:
                self.last_stderr.append(text)
            if text.startswith(_BANNER):
                host, _, port = text[len(_BANNER):].rpartition(":")
                return host, int(port)

    async def _drain_stderr(self) -> None:
        try:
            while True:
                line = await self.proc.stderr.readline()
                if not line:
                    return
                text = line.decode("utf-8", "replace").strip()
                if text:
                    self.last_stderr.append(text)
        except (asyncio.CancelledError, ConnectionError, OSError):
            pass

    async def wait(self) -> int:
        """Block until the current generation's process exits."""
        return await self.proc.wait()

    def kill(self) -> None:
        """SIGKILL the current generation (fault injection / last resort)."""
        if self.alive:
            with contextlib.suppress(ProcessLookupError):
                self.proc.kill()

    def pause(self) -> None:
        """SIGSTOP the current generation: alive but hung (fault
        injection — the router's health probe is what must notice)."""
        if self.alive:
            with contextlib.suppress(ProcessLookupError):
                self.proc.send_signal(signal.SIGSTOP)

    def resume(self) -> None:
        """SIGCONT a paused generation."""
        if self.alive:
            with contextlib.suppress(ProcessLookupError):
                self.proc.send_signal(signal.SIGCONT)

    async def stop(self, *, timeout: float = 15.0) -> None:
        """Graceful shutdown: close the client, SIGTERM, bounded wait.

        SIGTERM lands in the worker's own signal handler, which stops
        accepting, drains in-flight batches (``EvaluationService.drain``)
        and exits — the cascading half of the router's drain.
        """
        if self.client is not None:
            with contextlib.suppress(Exception):
                await self.client.aclose()
            self.client = None
        if self.alive:
            with contextlib.suppress(ProcessLookupError):
                self.proc.send_signal(signal.SIGTERM)
            try:
                await asyncio.wait_for(self.proc.wait(), timeout)
            except asyncio.TimeoutError:
                self.kill()
                await self.proc.wait()
        if self._stderr_task is not None:
            self._stderr_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._stderr_task
            self._stderr_task = None
