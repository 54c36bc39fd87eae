"""Chaos harness: drive a live ``HQIService`` while failpoints fire.

The self-healing contract this harness verifies, round after round, with
random subsets of the standard failpoint sites armed (``repro_torch.fault.
failpoints.SITES``) and — optionally — a writer subprocess SIGKILL'd
mid-commit, everything on ``ChaosConfig.device`` ("cuda" unless the caller
asks for the CPU):

  1. **No lost acked write.** Every insert whose ids were returned is in
     ``live_ids()`` after every subsequent crash + ``open_service`` recovery;
     every acknowledged delete stays dead. Writes that *failed* are
     indeterminate (the fault may have landed before or after durability) and
     are tracked as neither.
  2. **No hung query.** Every submitted query terminates within the harness
     timeout: fulfilled, or failed with a typed error (``QueryError``,
     ``DeadlineExceeded``) — never a handle nobody will ever set.
  3. **Exact parity.** Every successfully answered, non-degraded query
     matches ``exhaustive_search`` over the service's own state snapshot
     (captured quiescently between the round's write and query phases):
     same id set, same scores. Faults may fail queries; they may never
     silently corrupt answers.

Determinism: every choice — which sites arm, with what error/probability/
count, the write/delete/query streams — derives from one seed. Wall-clock
still influences micro-batch *composition* (which queries share a flush),
but all three invariants are composition-independent, so the asserted
outcome is deterministic even though scheduling is not.

The writer-kill phase waits for the child's first ``ACK`` line (a child
that imports torch and opens the store on the card may take seconds to
acknowledge anything; a fixed sleep could kill it before its first ack and
make the check hold trivially), lets it run ``KILL_AFTER_ACK_S`` longer and
then SIGKILLs it; no ack within ``FIRST_ACK_TIMEOUT_S`` fails the run.

CLI:  python -m repro_torch.fault.chaos [--smoke] [--device cuda|cpu] ...
      (exit code 1 when any invariant is violated; JSON report on stdout)
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..core import HQIConfig, HQIIndex
from ..core.baselines import exhaustive_search
from ..core.predicates import Between, In, make_filter
from ..core.types import Column, VectorDatabase, Workload
from ..service.errors import DeadlineExceeded, QueryError
from ..service.service import HQIService, ServiceConfig
from ..store import Compactor, open_service
from ..store.recovery import init_store
from . import failpoints

EXACT = 10_000  # nprobe past every list count: the engine scans exhaustively
# the writer-kill phase: the child's first ack within this, or the run fails
# (its start includes importing torch and loading the store onto the card);
# then it writes on this long before the SIGKILL
FIRST_ACK_TIMEOUT_S = 300.0
KILL_AFTER_ACK_S = 0.5

# (site, error kind) pool the harness draws from. wal.fsync gets a transient
# OSError (exercises the retry budget AND — with enough firings — poisoning);
# the pipeline sites get the default FailpointError (exercises containment).
_SITE_ERRORS: Tuple[Tuple[str, str], ...] = (
    ("wal.stage", "oserror"),
    ("wal.fsync", "oserror"),
    ("delta.apply", "runtimeerror"),
    ("service.flush", "failpoint"),
    ("scheduler.tick", "runtimeerror"),
    ("snapshot.write", "oserror"),
    ("compact.cycle", "failpoint"),
)


@dataclasses.dataclass
class ChaosConfig:
    seed: int = 0
    rounds: int = 4
    writes_per_round: int = 8
    insert_batch: int = 6
    deletes_per_round: int = 6
    queries_per_round: int = 50
    k: int = 5
    n0: int = 1200  # seed DB rows
    d: int = 16
    metric: str = "ip"
    sites_per_round: int = 3  # distinct failpoints armed per phase
    fault_count: int = 2  # firings per armed site (transient faults)
    poison_rounds: Tuple[int, ...] = (2,)  # rounds arming wal.fsync past its
    # retry budget — exercises WAL poisoning + clear_poison healing
    deadline_queries: int = 3  # per round, submitted with a ~0 deadline
    kill_writer: bool = True  # SIGKILL a writer subprocess, then recover
    compact_every: int = 2  # compact_once every N rounds (faults armed)
    result_timeout_s: float = 60.0  # per-query hang detector
    sync_wal: bool = True
    device: str = "cuda"  # the index, the child writer and the parity oracle


@dataclasses.dataclass
class ChaosReport:
    rounds: int = 0
    queries_submitted: int = 0
    answered_ok: int = 0
    failed_typed: int = 0  # QueryError / DeadlineExceeded — terminated
    hung: int = 0  # invariant 2: MUST stay 0
    degraded_answers: int = 0
    writes_acked: int = 0
    writes_failed: int = 0
    deletes_acked: int = 0
    parity_mismatches: int = 0  # invariant 3: MUST stay 0
    recovery_checks: int = 0
    recovery_violations: int = 0  # invariant 1: MUST stay 0
    restarts: int = 0
    poisons_healed: int = 0
    compactions: int = 0
    compaction_failures: int = 0
    killed_writers: int = 0
    killed_writer_acks: int = 0
    sites_fired: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return (
            self.hung == 0
            and self.parity_mismatches == 0
            and self.recovery_violations == 0
        )

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


# ---------------------------------------------------------------------------
# Synthetic store (self-contained — the harness must run from a stock binary)
# ---------------------------------------------------------------------------


def _synth_db(n: int, d: int, seed: int, metric: str) -> VectorDatabase:
    rng = np.random.default_rng(seed)
    return VectorDatabase(
        vectors=rng.normal(size=(n, d)).astype(np.float32),
        columns={
            "A": Column.numeric("A", rng.random(n).astype(np.float32)),
            "cat": Column.categorical(
                "cat", rng.integers(0, 8, n).astype(np.int32)
            ),
        },
        metric=metric,
    )


def _templates() -> List[tuple]:
    return [
        make_filter(),  # pure vector search
        make_filter(Between("A", 0.0, 0.5)),
        make_filter(In("cat", frozenset({0, 1, 2}))),
        make_filter(Between("A", 0.2, 0.9), In("cat", frozenset({1, 3, 5}))),
    ]


def _insert_payload(
    rng: np.random.Generator, n: int, d: int
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    return (
        rng.normal(size=(n, d)).astype(np.float32),
        {
            "A": rng.random(n).astype(np.float32),
            "cat": rng.integers(0, 8, n).astype(np.int32),
        },
    )


def _service_cfg(k: int) -> ServiceConfig:
    # EXACT nprobe: the engine answers exhaustively, so invariant 3 can demand
    # parity with brute force instead of a recall bound
    return ServiceConfig(k=k, nprobe=EXACT, max_batch=16, deadline_s=1e-3)


def _build_service(root: str, cfg: ChaosConfig) -> HQIService:
    db = _synth_db(cfg.n0, cfg.d, cfg.seed, cfg.metric)
    rng = np.random.default_rng(cfg.seed + 1)
    templates = _templates()
    wl = Workload(
        vectors=rng.normal(size=(32, cfg.d)).astype(np.float32),
        templates=templates,
        template_of=rng.integers(0, len(templates), 32).astype(np.int32),
        k=cfg.k,
    )
    index = HQIIndex.build(
        db, wl, HQIConfig(min_partition_size=128, max_leaves=8), device=cfg.device
    )
    return init_store(
        root, index, cfg=_service_cfg(cfg.k), sync=cfg.sync_wal, device=cfg.device
    )


# ---------------------------------------------------------------------------
# Round phases
# ---------------------------------------------------------------------------


def _arm_phase(
    rng: np.random.Generator,
    pool: Tuple[Tuple[str, str], ...],
    n_sites: int,
    count: int,
) -> List[str]:
    """Arm ``n_sites`` distinct sites drawn from ``pool``; returns names."""
    picks = rng.choice(len(pool), size=min(n_sites, len(pool)), replace=False)
    armed = []
    for p in picks:
        site, kind = pool[int(p)]
        failpoints.arm(
            site,
            kind,
            prob=float(rng.uniform(0.4, 1.0)),
            count=count,
            seed=int(rng.integers(0, 2**31)),
        )
        armed.append(site)
    return armed


def _write_phase(
    svc: HQIService,
    cfg: ChaosConfig,
    rng: np.random.Generator,
    must_live: Set[int],
    must_dead: Set[int],
    rep: ChaosReport,
) -> None:
    for _ in range(cfg.writes_per_round):
        vecs, cols = _insert_payload(rng, cfg.insert_batch, cfg.d)
        try:
            ids = svc.insert(vecs, cols)
        except Exception:
            # indeterminate: the fault may have hit before OR after the
            # record reached the log — the id set is unknown to the caller,
            # so it joins neither invariant set
            rep.writes_failed += 1
        else:
            rep.writes_acked += 1
            must_live.update(int(i) for i in ids)
    candidates = sorted(must_live)
    if candidates:
        picks = rng.choice(
            len(candidates),
            size=min(cfg.deletes_per_round, len(candidates)),
            replace=False,
        )
        for p in picks:
            gid = candidates[int(p)]
            # a delete ATTEMPT makes the id indeterminate even on failure
            # (the tombstone may be logged despite the raised fault)
            must_live.discard(gid)
            try:
                svc.delete([gid])
            except Exception:
                rep.writes_failed += 1
            else:
                rep.deletes_acked += 1
                must_dead.add(gid)


def _query_phase(
    svc: HQIService,
    cfg: ChaosConfig,
    rng: np.random.Generator,
    rep: ChaosReport,
) -> None:
    """Submit a query stream against the background loop; verify termination
    + parity. The parity reference is the service's own quiescent snapshot
    (no writes are in flight during this phase)."""
    db_snap = svc.snapshot_db()
    templates = _templates()
    t_of = rng.integers(0, len(templates), cfg.queries_per_round).astype(np.int32)
    qv = rng.normal(size=(cfg.queries_per_round, cfg.d)).astype(np.float32)
    deadline_picks = set(
        int(i)
        for i in rng.choice(
            cfg.queries_per_round,
            size=min(cfg.deadline_queries, cfg.queries_per_round),
            replace=False,
        )
    )
    svc.start(poll_s=1e-4)
    handles = []
    for i in range(cfg.queries_per_round):
        dl = 1e-9 if i in deadline_picks else None  # ~always expires
        try:
            h = svc.submit(qv[i], templates[int(t_of[i])], deadline_s=dl)
        except DeadlineExceeded:
            rep.failed_typed += 1  # rejected at admission: terminated
            handles.append(None)
        else:
            handles.append(h)
        rep.queries_submitted += 1
        if (i + 1) % 8 == 0:
            # trickle the stream across several micro-batches: a single
            # giant flush would give one fault the whole round's queries
            time.sleep(0.003)
    deadline_t = time.perf_counter() + cfg.result_timeout_s
    for h in handles:
        if h is None:
            continue
        if not h.wait(max(0.0, deadline_t - time.perf_counter())):
            rep.hung += 1  # invariant 2 violated
    svc.stop(drain=True)

    wl = Workload(vectors=qv, templates=templates, template_of=t_of, k=cfg.k)
    ref = exhaustive_search(db_snap, wl, device=cfg.device)
    for i, h in enumerate(handles):
        if h is None or not h.done:
            continue
        if h.error is not None:
            assert isinstance(
                h.error, (QueryError, DeadlineExceeded)
            ), f"untyped query failure: {h.error!r}"
            rep.failed_typed += 1
            continue
        rep.answered_ok += 1
        if h.degraded:
            rep.degraded_answers += 1
            continue  # approximate by design: excluded from exact parity
        got_i, got_s = h.ids, h.scores
        ref_pos = ref.ids[i]
        ref_gids = set(
            int(g) for g in np.asarray(db_snap.ids)[ref_pos[ref_pos >= 0]]
        )
        got_gids = set(int(g) for g in got_i[got_i >= 0])
        scores_match = np.allclose(
            np.where(np.isfinite(got_s), got_s, -1e30),
            np.where(np.isfinite(ref.scores[i]), ref.scores[i], -1e30),
            rtol=1e-4,
            atol=1e-4,
        )
        if got_gids != ref_gids or not scores_match:
            rep.parity_mismatches += 1


def _recovery_check(
    root: str,
    cfg: ChaosConfig,
    svc: HQIService,
    must_live: Set[int],
    must_dead: Set[int],
    rep: ChaosReport,
) -> HQIService:
    """Crash the process state (close the WAL, drop the service) and verify
    ``open_service`` restores every acked write; returns the new service."""
    svc.wal.close()
    svc2 = open_service(
        root, cfg=_service_cfg(cfg.k), sync=cfg.sync_wal, device=cfg.device
    )
    alive = set(int(i) for i in svc2.live_ids())
    rep.recovery_checks += 1
    if not must_live.issubset(alive) or (must_dead & alive):
        rep.recovery_violations += 1
    rep.restarts += 1
    return svc2


def _kill_writer_phase(
    root: str, cfg: ChaosConfig, seed: int, rep: ChaosReport
) -> Set[int]:
    """SIGKILL a subprocess mid-write-stream; every id it printed (= acked)
    must survive the parent's subsequent recovery."""
    with tempfile.TemporaryFile(mode="w+") as err:
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "repro_torch.fault.chaos",
                "--child",
                root,
                "--seed",
                str(seed),
                "--k",
                str(cfg.k),
                "--device",
                cfg.device,
            ],
            stdout=subprocess.PIPE,
            stderr=err,
            text=True,
            env=os.environ.copy(),
        )
        lines: List[str] = []
        first_ack = threading.Event()

        def read() -> None:  # the pipe drained as the child writes, so it never blocks
            for line in proc.stdout:
                lines.append(line)
                if line.startswith("ACK "):
                    first_ack.set()

        reader = threading.Thread(target=read, name="chaos-child-stdout", daemon=True)
        reader.start()
        try:
            acked_once = first_ack.wait(FIRST_ACK_TIMEOUT_S)
            if acked_once:
                # let it commit a few more batches, then kill without warning
                # (SIGKILL — no atexit, no flush, the genuine crash signature)
                time.sleep(KILL_AFTER_ACK_S)
        finally:
            proc.kill()
            proc.wait()
            reader.join()
        if not acked_once:
            err.seek(0)
            raise RuntimeError(
                f"chaos: the child writer acknowledged nothing in "
                f"{FIRST_ACK_TIMEOUT_S} s (exit {proc.returncode}); its "
                f"stderr ends: {err.read()[-2000:]!r}"
            )
    acked: Set[int] = set()
    for line in lines:
        # a line cut by the kill (no newline) was never fully acknowledged
        if line.startswith("ACK ") and line.endswith("\n"):
            acked.update(int(t) for t in line[4:].split(",") if t.strip())
    rep.killed_writers += 1
    rep.killed_writer_acks += len(acked)
    return acked


def _child_writer(root: str, seed: int, k: int, device: str) -> None:
    """``--child`` mode: open the store on ``device`` and stream insert
    batches until killed, printing each ACKED batch's ids (print AFTER the
    ack, so every printed id is covered by the durability contract)."""
    svc = open_service(root, cfg=_service_cfg(k), device=device)
    rng = np.random.default_rng(seed)
    d = svc.index.db.d
    while True:
        vecs, cols = _insert_payload(rng, 4, d)
        ids = svc.insert(vecs, cols)
        print("ACK " + ",".join(str(int(i)) for i in ids), flush=True)
        # pace the stream: the parent's recovery replays every acked record,
        # so an unthrottled burst would turn the invariant check into a
        # replay benchmark
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


def run_chaos(root: str, cfg: Optional[ChaosConfig] = None) -> ChaosReport:
    cfg = cfg or ChaosConfig()
    rng = np.random.default_rng(cfg.seed)
    rep = ChaosReport()
    failpoints.disarm_all()
    svc = _build_service(root, cfg)
    must_live: Set[int] = set()
    must_dead: Set[int] = set()
    write_pool = tuple(
        (s, k) for s, k in _SITE_ERRORS if s.startswith(("wal.", "delta."))
    )
    compact_pool = tuple(
        (s, k) for s, k in _SITE_ERRORS if s in ("snapshot.write", "compact.cycle")
    )
    try:
        for rnd in range(cfg.rounds):
            rep.rounds += 1
            # -- write phase: store-layer faults armed
            count = cfg.fault_count
            if rnd in cfg.poison_rounds:
                # enough consecutive fsync failures to blow the retry budget
                failpoints.arm(
                    "wal.fsync",
                    "oserror",
                    count=svc.wal.fsync_retries + 2,
                    seed=int(rng.integers(0, 2**31)),
                )
                _arm_phase(rng, write_pool[:1] + write_pool[2:], 2, count)
            else:
                _arm_phase(rng, write_pool, cfg.sites_per_round, count)
            _write_phase(svc, cfg, rng, must_live, must_dead, rep)
            _note_fired(rep)
            failpoints.disarm_all()
            # heal quarantines the faults may have tripped: a poisoned WAL
            # clears in place (operator path); a diverged apply needs the
            # restart+replay path — which is itself a recovery check
            if svc.wal.poisoned is not None:
                svc.wal.clear_poison()
                rep.poisons_healed += 1
            if svc._write_poisoned is not None:
                svc = _recovery_check(root, cfg, svc, must_live, must_dead, rep)

            # -- query phase: serving faults armed, parity asserted.
            # Bounded counts + sub-1.0 probability so SOME flushes crash
            # (containment exercised) while others answer (parity exercised)
            failpoints.arm(
                "service.flush",
                "failpoint",
                prob=0.5,
                count=2,
                seed=int(rng.integers(0, 2**31)),
            )
            failpoints.arm(
                "scheduler.tick",
                "runtimeerror",
                prob=0.5,
                count=2,
                seed=int(rng.integers(0, 2**31)),
            )
            _query_phase(svc, cfg, rng, rep)
            _note_fired(rep)
            failpoints.disarm_all()

            # -- compaction under fire (every compact_every rounds)
            if cfg.compact_every and (rnd + 1) % cfg.compact_every == 0:
                _arm_phase(rng, compact_pool, 1, count)
                try:
                    Compactor(svc, root).compact_once(force=True)
                    rep.compactions += 1
                except Exception:
                    rep.compaction_failures += 1  # old generation must serve
                _note_fired(rep)
                failpoints.disarm_all()

            # -- crash + recover, verify the durability invariant
            svc = _recovery_check(root, cfg, svc, must_live, must_dead, rep)

        # -- writer-kill phase: a subprocess dies mid-commit, parent recovers
        if cfg.kill_writer:
            svc.wal.close()
            acked = _kill_writer_phase(root, cfg, cfg.seed + 999, rep)
            svc = open_service(
                root, cfg=_service_cfg(cfg.k), sync=cfg.sync_wal, device=cfg.device
            )
            alive = set(int(i) for i in svc.live_ids())
            must_live.update(acked)
            rep.recovery_checks += 1
            if not acked.issubset(alive) or (must_dead & alive):
                rep.recovery_violations += 1
    finally:
        failpoints.disarm_all()
        if svc._thread is not None:
            svc.stop(drain=False)
    return rep


def _note_fired(rep: ChaosReport) -> None:
    for site in failpoints.SITES:
        n = failpoints.fired(site)
        if n:
            rep.sites_fired[site] = rep.sites_fired.get(site, 0) + n


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description="HQIService chaos harness")
    ap.add_argument("--root", default=None, help="store dir (default: tmp)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument(
        "--device", default="cuda", help="where the store serves (default: cuda)"
    )
    ap.add_argument("--no-kill", action="store_true", help="skip SIGKILL phase")
    ap.add_argument(
        "--smoke", action="store_true", help="small fast config (CI)"
    )
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.child is not None:
        _child_writer(args.child, args.seed, args.k, args.device)
        return 0  # unreachable: the parent kills us

    cfg = ChaosConfig(seed=args.seed, k=args.k, device=args.device)
    if args.smoke:
        cfg = dataclasses.replace(
            cfg, rounds=2, queries_per_round=25, writes_per_round=4, n0=800,
            poison_rounds=(1,),
        )
    if args.rounds is not None:
        cfg = dataclasses.replace(cfg, rounds=args.rounds)
    if args.queries is not None:
        cfg = dataclasses.replace(cfg, queries_per_round=args.queries)
    if args.no_kill:
        cfg = dataclasses.replace(cfg, kill_writer=False)

    if args.root is None:
        with tempfile.TemporaryDirectory(prefix="hqi-chaos-") as root:
            rep = run_chaos(root, cfg)
    else:
        rep = run_chaos(args.root, cfg)
    print(json.dumps(rep.as_dict(), indent=1, sort_keys=True))
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
