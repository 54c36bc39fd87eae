"""Bounded retry with exponential backoff + jitter for transient I/O faults.

The store layer's durability calls — the WAL group-commit fsync, snapshot
blob streaming — can fail transiently (NFS hiccup, overloaded disk, the
chaos harness's armed ``count=N`` failpoints) without the data being wrong.
Crashing a serving process on the first ``OSError`` turns a 2 ms hiccup into
a full restart + recovery; retrying forever turns a dead disk into a hung
commit. ``with_retries`` is the bounded middle: a few attempts, exponential
backoff so a struggling device is not hammered, jitter so concurrent
retriers decorrelate, and the LAST error propagated when attempts run out —
at which point the caller escalates (the WAL poisons itself into read-only
quarantine, the compactor backs off and reports through the registry).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

__all__ = ["with_retries"]


def backoff_delays(
    attempts: int,
    *,
    base_s: float = 0.002,
    max_s: float = 0.25,
    jitter: float = 0.5,
    rng: Optional[random.Random] = None,
):
    """The sleep schedule between attempts: ``base · 2^i`` capped at
    ``max_s``, each scaled by ``1 + U(0, jitter)``. ``attempts - 1`` values
    (no sleep after the final failure)."""
    rng = rng or random.Random()
    for i in range(max(0, attempts - 1)):
        d = min(max_s, base_s * (2.0 ** i))
        yield d * (1.0 + jitter * rng.random())


def with_retries(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_s: float = 0.002,
    max_s: float = 0.25,
    jitter: float = 0.5,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn`` up to ``attempts`` times; return its first success.

    Only ``retry_on`` errors are retried — anything else (assertion,
    corruption, KeyboardInterrupt) propagates immediately, because retrying
    a *logic* error just repeats it with extra latency. ``on_retry(attempt,
    error)`` is the observability hook (the WAL counts fsync retries through
    it). The final failure re-raises the last error unchanged so callers
    keep their existing except clauses.
    """
    assert attempts >= 1
    delays = backoff_delays(
        attempts, base_s=base_s, max_s=max_s, jitter=jitter, rng=rng
    )
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — the whole point
            last = e
            if on_retry is not None:
                on_retry(attempt + 1, e)
            try:
                sleep(next(delays))
            except StopIteration:
                break
    assert last is not None
    raise last
