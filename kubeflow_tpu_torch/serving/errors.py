"""Shared request-fault taxonomy for the serving stack.

Lives in its own dependency-free module so the HTTP server (server.py,
deliberately import-light) and the torch-heavy engine can both raise/catch
the same class without a server→engine import edge.  A copy of
``kubeflow_tpu/serving/errors.py``: the port imports nothing from the JAX
package.
"""

from __future__ import annotations


class RequestError(ValueError):
    """A per-request client fault (malformed body, empty prompt, unknown
    adapter, prompt beyond capacity) — the serving layer maps this, and
    ONLY this, to HTTP 400; any other exception is a 500 server fault.
    Subclasses ValueError so pre-taxonomy callers' `except ValueError`
    handlers keep working."""


class EngineError(RuntimeError):
    """Base of the engine's typed fault taxonomy (README "Failure model").

    Everything a ``generate_async`` Future can raise — as opposed to
    resolve — derives from this, so callers can write one `except
    EngineError` for "the engine refused/abandoned my request" while
    still matching subclasses for specific handling (the HTTP layer maps
    them to distinct status codes)."""


class DeadlineExceeded(EngineError):
    """The request's deadline expired before its first token: it was shed
    from the queue without (or mid-) prefill.  HTTP 504.  Shedding happens
    only BEFORE decode starts — a request already producing tokens runs to
    completion (the client's cancel path covers abandonment)."""


class SessionBusy(EngineError):
    """A second request named a ``session_id`` that already has a request
    queued or in flight: a session's KV timeline is strictly serial (turn
    N+1's restore depends on turn N's pin), so concurrent turns are
    refused at submit.  HTTP 409 — retry after the in-flight turn
    resolves."""


class EngineOverloaded(EngineError):
    """Admission control: the engine queue is at ``max_queue_depth`` and the
    submission was refused immediately (backpressure instead of unbounded
    queue growth).  HTTP 503 — retry against another replica or later."""


class EngineShutdown(EngineError):
    """The engine stopped (drain) before this request could run; queued work
    is resolved with this instead of being silently stranded.  HTTP 503."""


class TickFailure(EngineError):
    """A request was rejected after repeated engine-tick failures (the
    per-request consecutive-failure cap), or because the serving loop
    died/hung with the request in flight.  The underlying cause is chained
    via ``__cause__``.  HTTP 500 — the request failed alone; the engine
    keeps serving."""


class NonFiniteLogits(TickFailure):
    """The sample path saw NaN/Inf logits for this request's row; the slot
    was failed instead of committing garbage tokens.  Numerical poison is
    sticky (it lives in the KV state), so this is not retried."""
