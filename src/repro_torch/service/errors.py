"""Typed serving errors — the structured failure surface of ``HQIService``.

The self-healing contract (``repro_torch.fault``) is that every submitted query
*terminates*: answered, or failed with one of these errors carrying enough
structure for a caller (or the future router tier) to act on — retry, shed,
or surface. Bare ``RuntimeError``s are exactly what a router cannot route.
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "DeadlineExceeded",
    "QueryError",
    "QueueFull",
    "ResultPending",
    "ServiceReadOnly",
]


class QueueFull(RuntimeError):
    """Admission control: the pending queue is at ``queue_bound``."""


class ResultPending(RuntimeError):
    """``QueryHandle.result()`` called before the query was answered
    (non-blocking form; pass ``timeout=`` for the blocking accessor)."""


class DeadlineExceeded(TimeoutError):
    """A deadline lapsed: a per-query serving deadline expired before the
    answer was produced, or ``QueryHandle.result(timeout=)`` timed out."""

    def __init__(self, message: str, *, qid: Optional[int] = None) -> None:
        super().__init__(message)
        self.qid = qid


class QueryError(RuntimeError):
    """A query's flush pipeline failed; ``cause`` is the underlying error.

    Raised by ``QueryHandle.result()`` when the handle was *failed* rather
    than fulfilled — the flush that carried it crashed (and was contained:
    the service keeps serving subsequent flushes).
    """

    def __init__(self, message: str, *, qid: int, cause: BaseException) -> None:
        super().__init__(message)
        self.qid = qid
        self.cause = cause
        self.__cause__ = cause


class ServiceReadOnly(RuntimeError):
    """Writes are quarantined (poisoned WAL or a diverged delta apply);
    reads keep serving. ``cause`` is the fault that tripped the quarantine."""

    def __init__(self, message: str, *, cause: Optional[BaseException] = None) -> None:
        super().__init__(message)
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause
