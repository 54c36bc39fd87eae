"""Process-wide failpoint registry: named fault-injection sites (a copy of
``repro.fault.failpoints``: same sites, same ``REPRO_FAILPOINTS`` grammar).

A *failpoint* is a named hook compiled into a production code path —
``failpoints.failpoint("wal.fsync")`` — that normally does nothing and can be
*armed* to raise a chosen error with a chosen probability for a bounded
number of firings. The store and service layers thread sites through every
I/O and pipeline stage whose failure a serving deployment must survive, and
a chaos harness drives a live service with random subsets armed,
asserting the standing invariants (no hung query, no lost acked write, exact
parity on non-degraded answers). The port's harness (``fault/chaos.py``)
waits for its own item (ROADMAP.md §1, ``fault/chaos.py`` and ``tuner/``);
of the sites, the service layer's (``service.flush``, ``scheduler.tick``,
``delta.apply``, ``tuner.swap``) are threaded through the port today.

Cost discipline (same pattern as ``obs.trace``'s ``NullTracer``): the hot
path of a *disarmed* process is one module-global load and a falsy branch —
no dict lookup, no lock, nothing allocated — so instrumentation left in the
WAL commit path or the flush loop is free in production.

Arming:

  * programmatic — ``arm("wal.fsync", error=OSError, count=2)`` (first two
    evaluations raise, then the site heals: exactly a transient fault), or
    the ``armed(...)`` context manager tests use;
  * by environment — ``REPRO_FAILPOINTS="wal.fsync=oserror:p0.5:n3,
    service.flush=runtimeerror"`` arms sites at import time, so a stock
    binary can be chaos-tested with no code changes. Grammar per site:
    ``name=kind[:pP][:nN][:sS][:seedX]`` — error kind (oserror | ioerror |
    runtimeerror | timeout | failpoint), firing probability ``p`` (default
    1.0), max firings ``n`` (default unbounded), initial evaluations to skip
    ``s`` (default 0), RNG seed for the probability draw (default 0 —
    deterministic by default, as every chaos artifact must be).

Site names are dotted ``layer.stage`` strings; the standard sites are listed
in ``SITES``. Unknown names are legal —
``failpoint`` is self-registering — but ``arm`` warns loudly via
``KeyError`` when ``strict=True`` and the name is not a known site.
"""
from __future__ import annotations

import dataclasses
import os
import random
import threading
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Union

__all__ = [
    "FailpointError",
    "SITES",
    "arm",
    "armed",
    "disarm",
    "disarm_all",
    "evaluated",
    "failpoint",
    "fired",
    "list_armed",
]


class FailpointError(RuntimeError):
    """Default error an armed failpoint raises (kind "failpoint")."""


# The standard sites threaded through the store and service layers. Keeping
# the list here (not just in the README) lets the chaos harness arm "all the
# real sites" without string drift and lets tests assert coverage.
SITES = (
    "wal.stage",        # WriteAheadLog.stage — frame write into the OS
    "wal.fsync",        # WriteAheadLog.sync_upto — the group-commit fsync
    "snapshot.write",   # snapshot._write_generation — per-blob stream to disk
    "snapshot.load",    # snapshot._load_snapshot — generation open
    "compact.cycle",    # Compactor.compact_once — top of a fold→snapshot cycle
    "service.flush",    # HQIService._flush — the answer pipeline
    "delta.apply",      # DeltaStore.commit_insert — post-WAL state apply
    "scheduler.tick",   # HQIService.tick — the background loop's poll step
    "tuner.build",      # Tuner._build — off-to-the-side index rebuild
    "tuner.swap",       # HQIService.swap_index — pre-mutation swap gate
)

_ERROR_KINDS: Dict[str, Callable[[str], BaseException]] = {
    "oserror": lambda site: OSError(f"injected fault at {site}"),
    "ioerror": lambda site: IOError(f"injected fault at {site}"),
    "runtimeerror": lambda site: RuntimeError(f"injected fault at {site}"),
    "timeout": lambda site: TimeoutError(f"injected fault at {site}"),
    "failpoint": lambda site: FailpointError(f"injected fault at {site}"),
}


@dataclasses.dataclass
class _Armed:
    """One armed site's firing policy (mutated under the registry lock)."""

    make_error: Callable[[str], BaseException]
    prob: float = 1.0
    remaining: Optional[int] = None  # firings left; None = unbounded
    skip: int = 0  # evaluations to pass through before becoming eligible
    rng: random.Random = dataclasses.field(default_factory=lambda: random.Random(0))


# Hot-path contract: ``_ACTIVE`` is True iff at least one site is armed. The
# disarmed fast path in ``failpoint`` reads it WITHOUT the lock — arming is
# rare and racing a concurrent arm only delays the first injection by one
# evaluation, while taking a lock per call would tax every production commit.
_ACTIVE = False
_LOCK = threading.Lock()
_ARMED: Dict[str, _Armed] = {}
_EVALS: Dict[str, int] = {}  # evaluations of armed sites (diagnostics)
_FIRED: Dict[str, int] = {}  # errors actually raised, per site


def failpoint(name: str) -> None:
    """Evaluate the failpoint ``name``; raises iff the site is armed and its
    policy fires. The disarmed cost is one global load + branch."""
    if not _ACTIVE:
        return
    _evaluate(name)


def _evaluate(name: str) -> None:
    with _LOCK:
        fp = _ARMED.get(name)
        if fp is None:
            return
        _EVALS[name] = _EVALS.get(name, 0) + 1
        if fp.skip > 0:
            fp.skip -= 1
            return
        if fp.remaining is not None and fp.remaining <= 0:
            return
        if fp.prob < 1.0 and fp.rng.random() >= fp.prob:
            return
        if fp.remaining is not None:
            fp.remaining -= 1
        _FIRED[name] = _FIRED.get(name, 0) + 1
        err = fp.make_error(name)
    raise err


def arm(
    name: str,
    error: Union[str, BaseException, type, Callable[[str], BaseException]] = "failpoint",
    *,
    prob: float = 1.0,
    count: Optional[int] = None,
    skip: int = 0,
    seed: int = 0,
    strict: bool = True,
) -> None:
    """Arm site ``name``: subsequent ``failpoint(name)`` calls may raise.

    ``error`` is an error-kind string (see ``_ERROR_KINDS``), an exception
    class, a ready exception instance (raised as-is every firing), or a
    factory ``site -> exception``. ``prob`` is the per-evaluation firing
    probability (seeded — deterministic across runs), ``count`` bounds total
    firings (transient faults: fail N times, then heal), ``skip`` passes the
    first N evaluations through untouched (fault the *middle* of a stream).
    """
    if strict and name not in SITES:
        raise KeyError(
            f"unknown failpoint {name!r}; known sites: {', '.join(SITES)} "
            f"(arm(strict=False) to target an ad-hoc site)"
        )
    if isinstance(error, str):
        kind = error.lower()
        if kind not in _ERROR_KINDS:
            raise ValueError(
                f"unknown error kind {error!r}; one of {sorted(_ERROR_KINDS)}"
            )
        make = _ERROR_KINDS[kind]
    elif isinstance(error, BaseException):
        make = lambda _site, _e=error: _e  # noqa: E731
    elif isinstance(error, type) and issubclass(error, BaseException):
        make = lambda site, _cls=error: _cls(f"injected fault at {site}")  # noqa: E731
    else:
        make = error  # factory
    global _ACTIVE
    with _LOCK:
        _ARMED[name] = _Armed(
            make_error=make,
            prob=float(prob),
            remaining=None if count is None else int(count),
            skip=int(skip),
            rng=random.Random(seed),
        )
        _ACTIVE = True


def disarm(name: str) -> None:
    global _ACTIVE
    with _LOCK:
        _ARMED.pop(name, None)
        _ACTIVE = bool(_ARMED)


def disarm_all() -> None:
    global _ACTIVE
    with _LOCK:
        _ARMED.clear()
        _EVALS.clear()
        _FIRED.clear()
        _ACTIVE = False


@contextmanager
def armed(name: str, error="failpoint", **kw):
    """Scoped arm/disarm for tests: ``with armed("wal.fsync", OSError): ...``"""
    arm(name, error, **kw)
    try:
        yield
    finally:
        disarm(name)


def fired(name: str) -> int:
    """How many times site ``name`` actually raised since the last reset."""
    with _LOCK:
        return _FIRED.get(name, 0)


def evaluated(name: str) -> int:
    """How many times site ``name`` was evaluated while armed."""
    with _LOCK:
        return _EVALS.get(name, 0)


def list_armed() -> Dict[str, Dict[str, Union[float, int, None]]]:
    """Armed sites and their policies (for health dumps / diagnostics)."""
    with _LOCK:
        return {
            n: {"prob": fp.prob, "remaining": fp.remaining, "skip": fp.skip}
            for n, fp in _ARMED.items()
        }


# ---------------------------------------------------------------------------
# Environment activation: REPRO_FAILPOINTS="site=kind[:pP][:nN][:sS][:seedX],…"
# ---------------------------------------------------------------------------


def _arm_from_env(spec: str) -> None:
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, policy = entry.partition("=")
        parts = (policy or "failpoint").split(":")
        kind = parts[0] or "failpoint"
        kw: Dict[str, float] = {}
        for p in parts[1:]:
            if p.startswith("seed"):
                kw["seed"] = int(p[4:])
            elif p.startswith("p"):
                kw["prob"] = float(p[1:])
            elif p.startswith("n"):
                kw["count"] = int(p[1:])
            elif p.startswith("s"):
                kw["skip"] = int(p[1:])
            else:
                raise ValueError(f"bad REPRO_FAILPOINTS policy token {p!r} in {entry!r}")
        arm(name.strip(), kind, strict=False, **kw)


_env = os.environ.get("REPRO_FAILPOINTS", "")
if _env:
    _arm_from_env(_env)
