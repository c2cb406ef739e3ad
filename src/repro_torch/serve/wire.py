"""Wire-protocol plumbing shared by the serve front-ends: framing + limits.

The protocol is JSON-lines: one request object per ``\\n``-terminated line.
Nothing here parses JSON — this module is about the *byte* layer that the
seed implementation got wrong: ``asyncio.StreamReader.readline`` enforces a
64 KiB default limit and raises ``ValueError: Separator is found, but chunk
is longer than limit`` on a practically-sized ``register_qrel`` payload
(the paper's Q=1000×D=1000 grid serializes to tens of megabytes), killing
the connection without a response.

:func:`iter_frames` replaces ``readline`` with an explicit chunked scanner:

* complete lines are yielded as ``bytes`` (without the terminator);
* a line longer than ``limit`` yields ONE :class:`OversizedFrame` marker
  the moment the limit is crossed, then the rest of that line is discarded
  quietly until its terminator — so the caller can send a structured
  ``frame_too_large`` error *response* and keep the connection alive;
* a trailing frame without a final newline is yielded at EOF (pipes).

:class:`TokenBucket` is the per-connection rate limiter used by the TCP
front-end: ``await acquire()`` in the reader loop delays reading the next
request once a connection exceeds its budget, which throttles abusive
clients smoothly (delayed responses, never dropped requests) and composes
with request coalescing.  The clock is injectable so tests are exact.

Error *codes* carried by ``ok: false`` responses live here too
(:data:`ERROR_CODES`); :class:`ProtocolError` is how request handlers raise
a violation with a machine-readable code attached.
"""

from __future__ import annotations

import asyncio
import time
from typing import AsyncIterator, Callable, Optional, Union

#: default maximum request/response line length in bytes (64 MiB).  The
#: asyncio default of 64 KiB (2**16) rejected any real qrel registration;
#: this default admits the paper-scale grids with headroom and is plumbed
#: through ``serve_tcp`` / ``serve_stdio`` / ``--max-frame-mb``.
DEFAULT_FRAME_LIMIT = 64 * 1024 * 1024

#: bytes pulled off the transport per read while scanning for newlines
_CHUNK = 1 << 16

#: machine-readable ``code`` values on ``ok: false`` responses.  Clients
#: switch on these (``repro_torch.client`` maps ``auth_*`` to ``AuthError``);
#: the human-readable ``error`` string is for humans and NOT stable.
ERROR_CODES = (
    "bad_request",      # unparseable line / not a JSON object
    "unknown_op",       # op not in the protocol table
    "missing_field",    # a required field for this op is absent
    "invalid",          # field present but unusable (type/value)
    "not_found",        # unknown qrel_id / run_ref
    "auth_required",    # server has a token, connection not authenticated
    "bad_auth",         # auth attempted with the wrong token
    "frame_too_large",  # request line exceeded the frame limit
    "worker_unavailable",  # cluster router: owning worker down, not retried
    "deadline_exceeded",  # the request's deadline_ms budget ran out first
    "internal",         # anything else — a server-side bug, not the client
)


class ProtocolError(ValueError):
    """A request violated the wire protocol; carries the response code."""

    def __init__(self, message: str, code: str = "invalid"):
        super().__init__(message)
        assert code in ERROR_CODES, code
        self.code = code


class OversizedFrame:
    """Marker yielded by :func:`iter_frames` for a too-long request line.

    ``size`` is the number of bytes seen when the limit was crossed — a
    lower bound on the frame's true length (the rest is still being
    discarded when the marker is yielded).
    """

    __slots__ = ("size", "limit")

    def __init__(self, size: int, limit: int):
        self.size = size
        self.limit = limit

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"OversizedFrame(size={self.size}, limit={self.limit})"


async def iter_frames(reader: asyncio.StreamReader,
                      limit: int = DEFAULT_FRAME_LIMIT,
                      ) -> AsyncIterator[Union[bytes, OversizedFrame]]:
    """Yield newline-delimited frames from ``reader``, bounded by ``limit``.

    Unlike ``reader.readline()`` this never raises on a long line: the
    oversized frame degrades to one :class:`OversizedFrame` marker and the
    stream stays aligned on the next line.  Connection errors propagate.
    """
    buf = bytearray()
    discarding = False  # inside an oversized line, waiting for its newline
    while True:
        chunk = await reader.read(_CHUNK)
        at_eof = not chunk
        buf.extend(chunk)
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                break
            frame = bytes(buf[:nl])
            del buf[:nl + 1]
            if discarding:
                discarding = False  # tail of the oversized line: drop it
            elif len(frame) > limit:  # whole long line arrived in one read
                yield OversizedFrame(len(frame), limit)
            else:
                yield frame
        if discarding:
            buf.clear()  # still mid-oversized-line: keep discarding
        elif len(buf) > limit:
            yield OversizedFrame(len(buf), limit)
            buf.clear()
            discarding = True
        if at_eof:
            if buf and not discarding:
                yield bytes(buf)  # trailing frame without a newline (pipes)
            return


def split_frames(data: bytes, limit: int = DEFAULT_FRAME_LIMIT):
    """Synchronous sibling of :func:`iter_frames` for durable on-disk logs.

    Yields each complete (newline-terminated) frame as ``bytes``; a frame
    over ``limit`` degrades to one :class:`OversizedFrame` marker exactly
    like the streaming scanner.  Unlike :func:`iter_frames` — whose EOF is
    a *clean* end of a pipe — trailing bytes without a newline mean the
    writer crashed mid-append, so the torn tail is silently dropped and
    replay stops at the last durable record.

    >>> [bytes(f) for f in split_frames(b'{"a":1}\\n{"b":2}\\n{"torn')]
    [b'{"a":1}', b'{"b":2}']
    >>> [f for f in split_frames(b'xxxxx\\nok\\n', limit=3)]
    [OversizedFrame(size=5, limit=3), b'ok']
    """
    start = 0
    while True:
        nl = data.find(b"\n", start)
        if nl < 0:
            return  # torn tail (or clean EOF right after a newline)
        frame = data[start:nl]
        if len(frame) > limit:
            yield OversizedFrame(len(frame), limit)
        else:
            yield frame
        start = nl + 1


class TokenBucket:
    """Classic token-bucket limiter: ``rate`` tokens/s, capacity ``burst``.

    ``acquire()`` reserves one token, sleeping exactly as long as the
    reservation requires; reservations queue FIFO by letting the token
    count go negative, so a burst beyond capacity spreads out at ``rate``
    rather than stampeding when the bucket refills.

    >>> b = TokenBucket(rate=10, burst=2, clock=lambda: 0.0)
    >>> [round(b.reserve(), 2) for _ in range(4)]  # 2 free, then 10/s
    [0.0, 0.0, 0.1, 0.2]
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if rate <= 0:
            raise ValueError(f"rate must be > 0 tokens/s, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst is not None else max(1.0, rate)
        if self.burst < 1.0:
            raise ValueError(f"burst must be >= 1 token, got {self.burst}")
        self._clock = clock or time.monotonic
        self._tokens = self.burst
        self._last = self._clock()

    def reserve(self) -> float:
        """Take one token; return how long the caller must wait for it."""
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now
        self._tokens -= 1.0
        if self._tokens >= 0.0:
            return 0.0
        return -self._tokens / self.rate

    async def acquire(self) -> None:
        """Reserve a token and sleep out the wait (possibly zero)."""
        wait = self.reserve()
        if wait > 0:
            await asyncio.sleep(wait)
