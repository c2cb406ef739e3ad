"""Exception taxonomy for the evaluation client.

Three failure families, matching what a caller can actually do about them:

* :class:`ServerError` — the server answered ``ok: false``.  The request
  was *delivered and rejected*; retrying the same bytes will fail the same
  way.  Carries the machine-readable ``code``
  (:data:`repro_torch.serve.wire.ERROR_CODES`) and the echoed request id.
  :class:`AuthError` is the ``auth_required`` / ``bad_auth`` subset;
  :class:`WorkerUnavailableError` is the cluster router's
  ``worker_unavailable`` (the owning worker is down and the router will
  not retry on the caller's behalf).
* :class:`ConnectionLostError` — the transport died before a response
  arrived.  Idempotent requests are retried automatically
  (:class:`~repro_torch.client.aio.AsyncEvalClient`); this surfaces only once
  retries are exhausted.  Subclasses :class:`ConnectionError` so generic
  network handling catches it too.
* :class:`ProtocolError` — the server sent bytes that do not parse as a
  protocol response; a version mismatch or a corrupted stream, not
  something to retry.

All of them subclass :class:`ClientError`.
"""

from __future__ import annotations

from typing import Optional


class ClientError(Exception):
    """Base class for every error raised by ``repro_torch.client``."""


class ServerError(ClientError):
    """The server answered ``ok: false`` for this request."""

    def __init__(self, message: str, code: Optional[str] = None,
                 request_id=None):
        super().__init__(message)
        self.code = code or "internal"
        self.request_id = request_id

    def __str__(self) -> str:
        return f"[{self.code}] {self.args[0]}"


class AuthError(ServerError):
    """Authentication failed (``auth_required`` or ``bad_auth``)."""


class WorkerUnavailableError(ServerError):
    """A cluster router could not reach the worker owning this request.

    Raised only for requests the router will NOT transparently retry
    (``drop_qrel``, or idempotent ops once the router's retry budget is
    exhausted).  The request may or may not have executed — the caller
    decides whether re-sending is safe, which is exactly why the code is
    machine-readable instead of being folded into ``internal``.
    """


class DeadlineExceededError(ServerError):
    """The request's ``deadline_ms`` budget ran out before it completed.

    Raised either because the server (router or worker) answered with the
    ``deadline_exceeded`` code, or locally when a per-call ``timeout=``
    elapsed with no answer at all (hung server).  Either way the work may
    still complete server-side — a deadline bounds the *wait*, not the
    execution — so only idempotent requests are safe to re-send.
    """


class ConnectionLostError(ClientError, ConnectionError):
    """The connection dropped before this request's response arrived."""


class ProtocolError(ClientError):
    """The server sent a line that is not a valid protocol response."""


#: response codes that map to :class:`AuthError`
AUTH_CODES = frozenset({"auth_required", "bad_auth"})


def error_from_response(resp: dict) -> ServerError:
    """Build the right exception for an ``ok: false`` response object."""
    code = resp.get("code") or "internal"
    message = str(resp.get("error", "unknown server error"))
    if code in AUTH_CODES:
        cls = AuthError
    elif code == "worker_unavailable":
        cls = WorkerUnavailableError
    elif code == "deadline_exceeded":
        cls = DeadlineExceededError
    else:
        cls = ServerError
    return cls(message, code=code, request_id=resp.get("id"))
