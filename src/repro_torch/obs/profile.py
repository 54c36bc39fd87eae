"""Kernel-grained dispatch profiler with roofline attribution.

The tracer's spans show *that* a dispatch ran; this module shows *how
well*. The planner's dispatch sites fence their outputs inside a span
(``torch.cuda.synchronize`` while a profiler or tracer is on), so the wall
time between ``prof.t0()`` and the span close covers the device work. On
top of that timing each site reports the reference's plan-derived shape
facts, and the profiler attributes the dispatch:

  bytes touched   operand + output bytes of the bucket's padded shape (rows
                  or codes gathered from the PackedArena, the LUT rows the
                  resident scan reads, the outputs), as the reference
                  counts them
  distance FLOPs  2·d·Σ(nq·rows) for the f32 scan; 2·M·256·Σ(nq·rows) for
                  the ADC scan (the reference's one-hot contraction count,
                  kept so that both packages read the same work) — as
                  *real* work over live rows and as *padded* work over the
                  full bucket
  occupancy       real vs padded work units and rows per bucket — the
                  padding-waste % the bucket ladder trades for few dispatches
  roofline        achieved GB/s and GFLOP/s as a fraction of the
                  ``launch.roofline`` hardware terms (``REPRO_HW`` selectable;
                  h100 on an H100)

The port's kernels skip padding slots (``n_live``), but the counts stay
the reference's, so the two packages record equal rows for the same plan;
live-slot counts stay in ``DispatchStats`` and the smoke's records.

Aggregation is per (phase, mode, bucket shape) — phases: scan / merge /
rerank / gather — plus a per-mesh-rank table for a sharded path fed from
each dispatch's ``rank_units``/``rank_bytes``.

Cost discipline mirrors ``trace.NullTracer``: the default profiler is a
``NullProfiler`` singleton — ``get_profiler().enabled`` is one attribute
load, ``t0()`` returns 0 without reading a clock, and every attribution
branch in the planner is guarded by ``prof.enabled`` — so the hot path
allocates nothing when profiling is off (tracemalloc-asserted in tests).
Enabling installs the fence hold (``trace._set_fence_hold``) so timings are
fenced even without a tracer, attaches a ``"profile"`` source to the
metrics registry, and installs the ``kernels.ops`` issue hook so coverage
(attributed vs issued dispatches) is visible.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "KernelProfiler",
    "NullProfiler",
    "get_profiler",
    "set_profiler",
    "enable_profiler",
    "disable_profiler",
]


@dataclasses.dataclass
class DispatchAgg:
    """Running totals for one (phase, mode, bucket shape) cell."""

    dispatches: int = 0
    device_s: float = 0.0
    bytes: int = 0
    flops: float = 0.0
    flops_padded: float = 0.0
    units: int = 0
    units_padded: int = 0
    rows: int = 0
    rows_padded: int = 0

    def derived(self, hw) -> Dict[str, Any]:
        t = self.device_s
        out = {
            "dispatches": self.dispatches,
            "device_s": t,
            "bytes": self.bytes,
            "flops": self.flops,
            "flops_padded": self.flops_padded,
            "units": self.units,
            "units_padded": self.units_padded,
            "rows": self.rows,
            "rows_padded": self.rows_padded,
            "gbps": (self.bytes / t / 1e9) if t > 0 else 0.0,
            "gflops": (self.flops / t / 1e9) if t > 0 else 0.0,
            "frac_hbm": (self.bytes / t / hw.hbm_bw) if t > 0 else 0.0,
            "frac_peak": (self.flops / t / hw.peak_flops) if t > 0 else 0.0,
            "unit_occupancy": (self.units / self.units_padded)
            if self.units_padded else 1.0,
            "row_occupancy": (self.rows / self.rows_padded)
            if self.rows_padded else 1.0,
            "flop_efficiency": (self.flops / self.flops_padded)
            if self.flops_padded else 1.0,
        }
        out["padding_waste"] = 1.0 - out["row_occupancy"]
        return out


class NullProfiler:
    """Disabled profiler: every call is a no-op, nothing is ever recorded."""

    enabled = False

    @staticmethod
    def t0() -> int:
        return 0

    def record_dispatch(self, *a, **kw) -> None:
        pass

    def reset(self) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": False}

    def report(self) -> Dict[str, Any]:
        return {"enabled": False}

    def totals(self, phase: Optional[str] = None, mode: Optional[str] = None) -> Dict[str, Any]:
        return {}

    def format_table(self) -> str:
        return "(profiler disabled)"


class KernelProfiler:
    """Accumulates fenced per-dispatch timings + shape-fact attribution."""

    enabled = True

    def __init__(self, hardware=None) -> None:
        if hardware is None:
            from ..launch.roofline import current_hardware

            hardware = current_hardware()
        self.hardware = hardware
        self._lock = threading.Lock()
        # (phase, mode, shape) -> DispatchAgg
        self._agg: Dict[Tuple[str, str, int], DispatchAgg] = {}
        # mesh rank -> {dispatches, units, bytes}
        self._ranks: Dict[int, Dict[str, int]] = {}
        self._issued: Dict[str, int] = {}  # ops-level hook: kind -> count
        self._attributed = 0

    # ------------------------------------------------------------- recording

    @staticmethod
    def t0() -> int:
        """Timestamp taken just before a fenced dispatch span opens."""
        return time.perf_counter_ns()

    def record_dispatch(
        self,
        phase: str,
        mode: str,
        shape: int,
        t0_ns: int,
        *,
        nbytes: int,
        flops: float,
        flops_padded: float,
        units: int,
        units_padded: int,
        rows: int,
        rows_padded: int,
        rank_units: Optional[Sequence[int]] = None,
        rank_bytes: Optional[Sequence[int]] = None,
    ) -> None:
        """Attribute one fenced dispatch (called right after its span closes,
        so perf_counter_ns() - t0_ns covers the block_until_ready)."""
        dt = (time.perf_counter_ns() - t0_ns) / 1e9 if t0_ns else 0.0
        key = (phase, mode, int(shape))
        with self._lock:
            agg = self._agg.get(key)
            if agg is None:
                agg = self._agg[key] = DispatchAgg()
            agg.dispatches += 1
            agg.device_s += dt
            agg.bytes += int(nbytes)
            agg.flops += float(flops)
            agg.flops_padded += float(flops_padded)
            agg.units += int(units)
            agg.units_padded += int(units_padded)
            agg.rows += int(rows)
            agg.rows_padded += int(rows_padded)
            self._attributed += 1
            if rank_units is not None:
                rb = rank_bytes if rank_bytes is not None else [0] * len(rank_units)
                for r, (u, b) in enumerate(zip(rank_units, rb)):
                    rr = self._ranks.get(r)
                    if rr is None:
                        rr = self._ranks[r] = {"dispatches": 0, "units": 0, "bytes": 0}
                    rr["dispatches"] += 1
                    rr["units"] += int(u)
                    rr["bytes"] += int(b)
        from .trace import get_tracer

        tracer = get_tracer()
        if tracer.enabled:
            tracer.instant(
                "profile.dispatch",
                phase=phase,
                mode=mode,
                shape=int(shape),
                device_us=round(dt * 1e6, 2),
                rows=int(rows),
                rows_padded=int(rows_padded),
            )

    def _on_issue(self, kind: str, shape) -> None:
        """kernels.ops hook: count every dispatch issued, attributed or not."""
        with self._lock:
            self._issued[kind] = self._issued.get(kind, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._agg.clear()
            self._ranks.clear()
            self._issued.clear()
            self._attributed = 0

    # --------------------------------------------------------------- reading

    @staticmethod
    def _key_str(key: Tuple[str, str, int]) -> str:
        return f"{key[0]}/{key[1]}/{key[2]}"

    def report(self) -> Dict[str, Any]:
        """Full attribution tables (the form bundles and obsdump persist)."""
        with self._lock:
            agg = {k: dataclasses.replace(v) for k, v in self._agg.items()}
            ranks = {r: dict(v) for r, v in self._ranks.items()}
            issued = dict(self._issued)
            attributed = self._attributed
        hw = self.hardware
        n_issued = sum(issued.values())
        return {
            "enabled": True,
            "hardware": hw.as_dict(),
            "phases": {
                self._key_str(k): agg[k].derived(hw) for k in sorted(agg)
            },
            "ranks": {str(r): ranks[r] for r in sorted(ranks)},
            "issued": issued,
            "attributed": attributed,
            "coverage": (attributed / n_issued) if n_issued else 1.0,
        }

    def totals(self, phase: Optional[str] = None, mode: Optional[str] = None) -> Dict[str, Any]:
        """Aggregate of all cells matching phase/mode (None = wildcard);
        ``{}`` when nothing matches (same contract as the NullProfiler)."""
        total = DispatchAgg()
        with self._lock:
            for (p, m, _s), a in self._agg.items():
                if phase is not None and p != phase:
                    continue
                if mode is not None and m != mode:
                    continue
                total.dispatches += a.dispatches
                total.device_s += a.device_s
                total.bytes += a.bytes
                total.flops += a.flops
                total.flops_padded += a.flops_padded
                total.units += a.units
                total.units_padded += a.units_padded
                total.rows += a.rows
                total.rows_padded += a.rows_padded
        if total.dispatches == 0:
            return {}
        return total.derived(self.hardware)

    def snapshot(self) -> Dict[str, Any]:
        """Compact rollup for the metrics-registry ``"profile"`` source."""
        by_phase: Dict[str, DispatchAgg] = {}
        with self._lock:
            for (p, _m, _s), a in self._agg.items():
                t = by_phase.get(p)
                if t is None:
                    t = by_phase[p] = DispatchAgg()
                t.dispatches += a.dispatches
                t.device_s += a.device_s
                t.bytes += a.bytes
                t.flops += a.flops
                t.flops_padded += a.flops_padded
                t.units += a.units
                t.units_padded += a.units_padded
                t.rows += a.rows
                t.rows_padded += a.rows_padded
            attributed = self._attributed
            n_issued = sum(self._issued.values())
        hw = self.hardware
        out: Dict[str, Any] = {
            "enabled": True,
            "hardware": hw.name,
            "attributed": attributed,
            "issued": n_issued,
        }
        for p in sorted(by_phase):
            d = by_phase[p].derived(hw)
            out[p] = {
                "dispatches": d["dispatches"],
                "device_s": round(d["device_s"], 6),
                "gbps": round(d["gbps"], 3),
                "gflops": round(d["gflops"], 3),
                "row_occupancy": round(d["row_occupancy"], 4),
            }
        return out

    def format_table(self) -> str:
        """Fixed-width text table (obsdump --profile, incident bundles)."""
        rep = self.report()
        hw = rep["hardware"]
        lines = [
            f"hardware: {hw['name']}  peak {hw['peak_flops'] / 1e12:g} TFLOP/s"
            f"  HBM {hw['hbm_bw'] / 1e9:g} GB/s",
            f"coverage: {rep['attributed']} attributed / "
            f"{sum(rep['issued'].values())} issued "
            f"({100.0 * rep['coverage']:.1f}%)",
            f"{'phase/mode/shape':<28}{'disp':>6}{'ms':>10}{'GB/s':>9}"
            f"{'GFLOP/s':>10}{'%HBM':>8}{'%peak':>8}{'occ':>7}{'waste':>7}",
        ]
        for key, d in rep["phases"].items():
            lines.append(
                f"{key:<28}{d['dispatches']:>6}{d['device_s'] * 1e3:>10.3f}"
                f"{d['gbps']:>9.2f}{d['gflops']:>10.2f}"
                f"{100 * d['frac_hbm']:>7.2f}%{100 * d['frac_peak']:>7.2f}%"
                f"{d['row_occupancy']:>7.2f}{100 * d['padding_waste']:>6.1f}%"
            )
        if rep["ranks"]:
            lines.append(f"{'rank':<8}{'disp':>8}{'units':>10}{'bytes':>14}")
            for r, v in rep["ranks"].items():
                lines.append(
                    f"{r:<8}{v['dispatches']:>8}{v['units']:>10}{v['bytes']:>14}"
                )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Process-wide profiler (default: disabled)
# ---------------------------------------------------------------------------

_NULL = NullProfiler()
_PROFILER = _NULL


def get_profiler():
    """The process-wide profiler every dispatch site reports to."""
    return _PROFILER


def set_profiler(p) -> None:
    """Install a profiler (None → the free NullProfiler) and wire the side
    channels: the trace fence hold (fenced timings without a tracer), the
    kernels.ops issue hook (dispatch coverage), and the metrics-registry
    ``"profile"`` source."""
    global _PROFILER
    _PROFILER = _NULL if p is None else p
    from . import trace as _trace
    from .metrics import get_registry

    _trace._set_fence_hold(_PROFILER.enabled)
    from ..kernels import ops as kops  # lazy: obs is imported by the hot paths

    kops.set_profile_hook(_PROFILER._on_issue if _PROFILER.enabled else None)
    if _PROFILER.enabled:
        get_registry().attach_source("profile", _PROFILER.snapshot)
    else:
        get_registry().detach_source("profile")


def enable_profiler(hardware=None) -> KernelProfiler:
    """Install (and return) a fresh recording profiler."""
    p = KernelProfiler(hardware=hardware)
    set_profiler(p)
    return p


def disable_profiler() -> None:
    """Back to the free no-op profiler."""
    set_profiler(None)
