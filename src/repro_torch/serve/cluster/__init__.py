"""Multi-worker serve cluster: a consistent-hash router over processes.

One ``repro_torch.serve`` process coalesces beautifully but is one asyncio loop
behind one GIL.  This package is the scale-out story: a router front-end
(:class:`~repro_torch.serve.cluster.router.Router`) speaking the *same*
JSON-lines protocol on its public port, consistent-hashing ``qrel_id``s
(:class:`~repro_torch.serve.cluster.ring.HashRing`) onto a supervised pool of
``python -m repro_torch.serve`` worker subprocesses
(:class:`~repro_torch.serve.cluster.worker.WorkerProcess`) and fanning requests
out/in over :class:`repro_torch.client.AsyncEvalClient` connections — each
collection interned by exactly one worker, each worker's micro-batcher
still coalescing the traffic aimed at it.  Every worker evaluates on the
device its command line names (``--device cuda``, the default, or
``--device cpu``); the router itself holds no tensor.

With ``replication >= 2`` each collection is owned by a *replica set*
(ring successor walk): registrations fan out to every live replica before
acking, reads balance across replicas with power-of-two-choices filtered
through per-worker circuit breakers
(:class:`~repro_torch.serve.cluster.breaker.CircuitBreaker`), and a replica
dying mid-request fails over to its sibling instantly.  Workers are
restarted with backoff on crash or failed health probe, and the router
replays its registration journal
(:class:`~repro_torch.serve.cluster.journal.RegistrationJournal` — durable on
disk with ``--state-dir``) onto the fresh process, so idempotent requests
(``evaluate``, ``compare``, ``register_*``) retry transparently across a
worker death; non-idempotent ``drop_qrel`` answers a machine-readable
``worker_unavailable`` error only when EVERY replica is unreachable.
Requests may carry ``deadline_ms`` — enforced end-to-end at the router
(``deadline_exceeded``), with hedged second requests for idempotent ops
near the deadline.

The chaos harness (:mod:`repro_torch.serve.cluster.chaos`) replays seeded
declarative fault schedules — kill, SIGSTOP-hang, response delay, byte
truncation — against a live cluster; ``tests/test_torch_cluster.py``
asserts results stay bit-identical to in-process evaluation and no
acknowledged registration is ever lost.  ``docs/SERVING.md`` (cluster
section) describes the topology and the failure-semantics matrix, which
this package shares with ``repro.serve.cluster`` byte for byte on the
wire; ``python -m repro_torch.serve.cluster --help`` lists the flags
(``repro.serve.cluster``'s plus ``--device``).
``tests/test_torch_cluster.py`` pins bit-identity against the in-process
evaluator and exercises the fault paths deterministically.

Every wait is bounded, including shutdown under Python 3.12, whose
``asyncio.Server.wait_closed()`` waits for every open connection: the
listeners here close with :func:`repro_torch.serve.frontend.close_server`.
"""

from repro_torch.serve.cluster.breaker import CircuitBreaker
from repro_torch.serve.cluster.chaos import (ChaosEvent, ChaosInjector,
                                       ChaosSchedule, FaultProxy,
                                       ProxyManager, inject)
from repro_torch.serve.cluster.journal import RegistrationJournal
from repro_torch.serve.cluster.ring import HashRing
from repro_torch.serve.cluster.router import Router
from repro_torch.serve.cluster.worker import WorkerProcess, WorkerStartupError

__all__ = [
    "ChaosEvent",
    "ChaosInjector",
    "ChaosSchedule",
    "CircuitBreaker",
    "FaultProxy",
    "HashRing",
    "ProxyManager",
    "RegistrationJournal",
    "Router",
    "WorkerProcess",
    "WorkerStartupError",
    "inject",
]
