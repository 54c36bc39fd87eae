"""Fault injection and retry: the failpoint registry and bounded retries.

Public API:
    failpoint / arm / armed / disarm / disarm_all / fired / evaluated /
        list_armed / SITES / FailpointError — the process-wide failpoint
        registry (failpoints.py); zero-cost when disarmed. Sites arm from
        code or from ``REPRO_FAILPOINTS`` at import time
    with_retries — bounded exponential-backoff retry for transient I/O

The chaos harness (``fault/chaos.py``: ``run_chaos``, ``python -m
repro_torch.fault.chaos``) drives a WAL-backed service while these fire; it
imports the store, so it is not imported here.
"""
from .failpoints import (  # noqa: F401
    SITES,
    FailpointError,
    arm,
    armed,
    disarm,
    disarm_all,
    evaluated,
    failpoint,
    fired,
    list_armed,
)
from .retry import with_retries  # noqa: F401
