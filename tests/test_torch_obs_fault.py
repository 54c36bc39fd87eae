"""The port's copies of the host-only modules against the reference:
``obs.metrics``, ``obs.drift``, ``fault.failpoints`` (with the
``REPRO_FAILPOINTS`` grammar) and ``fault.retry``. Each copy is fed the same
inputs as the reference's module and must give the same readings."""
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.fault import failpoints as ref_fp
from repro.fault import retry as ref_retry
from repro.obs import drift as ref_drift
from repro.obs import metrics as ref_metrics
from repro_torch.fault import failpoints as fp
from repro_torch.fault import retry
from repro_torch.kernels import ops
from repro_torch.obs import drift, metrics

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True)
def _clean():
    yield
    fp.disarm_all()
    ref_fp.disarm_all()


def test_histogram_counter_gauge_match_reference():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.lognormal(-6, 2, 500), [0.0, 1e-9, 5e11, 2e12]])
    a, b = ref_metrics.Histogram(), metrics.Histogram()
    for x in xs:
        a.observe(x)
        b.observe(x)
    assert a.to_json() == b.to_json()
    for q in (0, 1, 50, 90, 99, 100):
        assert a.percentile(q) == b.percentile(q)
    custom = metrics.Histogram(bounds=[1, 2, 4])
    for x in (0.5, 1.5, 3, 9):
        custom.observe(x)
    assert custom.to_json()["buckets"]["counts"] == [1, 1, 1, 1]
    c, g = metrics.Counter(), metrics.Gauge()
    c.inc(2)
    c.inc()
    g.set(7)
    assert (c.value, g.value) == (3.0, 7.0)


def test_registry_snapshot_objectives_and_dispatch_source():
    reg = metrics.MetricsRegistry()
    reg.counter("a.count").inc(4)
    reg.histogram("a.lat_s").observe(0.02)
    reg.attach_source("src", lambda: {"x": 1})
    reg.attach_source("dead", lambda: 1 / 0)
    snap = reg.snapshot()
    assert snap["a.count"] == 4.0 and snap["src"] == {"x": 1}
    assert "ZeroDivisionError" in snap["dead"]["error"]
    json.loads(reg.to_json(detail=True))
    with pytest.raises(TypeError):
        reg.gauge("a.count")
    slow = metrics.Objective("lat", "a.lat_s", stat="p99", max_value=0.01)
    assert "a.lat_s.p99" in slow.evaluate(reg)
    assert metrics.Objective("n", "a.count", stat="value", max_value=10).evaluate(reg) is None
    assert metrics.Objective("gone", "missing", max_value=0).evaluate(reg) is None
    # the default registry carries the port's kernel-dispatch counter
    old = metrics.set_registry(None)
    try:
        ops.reset_dispatch_stats()
        ops.dispatch_stats().record_knn((1, 2, 3, 4))
        d = metrics.get_registry().snapshot()["dispatch"]
        assert d["knn_calls"] == 1 and d["distinct_shapes"] == 1
    finally:
        metrics.set_registry(old)


def _feed(mod):
    """The same observation sequence into a reference or port monitor."""
    mon = mod.DriftMonitor(mod.DriftConfig(window=64, reservoir=4, seed=3))
    t = 100.0
    for i in range(50):
        mon.observe_queries([("T", i % 3), ("T", 0)] if i < 25 else [("T", 4)], t=t)
        mon.observe_probes({i % 5: 1 + i % 2})
        mon.observe_delta([10, 40, 5, 30][i % 4], t=t)
        mon.maybe_sample(np.full(4, i, np.float32), ("T", i % 2), np.arange(3) + i)
        t += 0.5
    return mon


def test_drift_monitor_matches_reference():
    a, b = _feed(ref_drift), _feed(drift)
    ra, rb = a.report(), b.report()
    assert ra.to_json() == rb.to_json()
    assert rb.share_shift > 0.5 and rb.delta_growth_per_s > 0
    (wa, sa), (wb, sb) = a.traffic_snapshot(), b.traffic_snapshot()
    assert wa == wb and len(sa) == len(sb) == 4
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x[0], y[0])
        assert x[1] == y[1]
        np.testing.assert_array_equal(x[2], y[2])
    b.reset()
    assert b.report().n_window == 0 and b.traffic_snapshot() == ([], [])


def test_failpoint_policies_match_reference():
    def run(mod):
        out = []
        mod.arm("service.flush", "runtimeerror", prob=0.5, count=5, skip=2, seed=9)
        for _ in range(30):
            try:
                mod.failpoint("service.flush")
                out.append(0)
            except RuntimeError:
                out.append(1)
        return out, mod.fired("service.flush"), mod.evaluated("service.flush")

    assert run(ref_fp) == run(fp)
    assert fp.fired("service.flush") == 5
    with pytest.raises(KeyError):
        fp.arm("no.such.site")
    with pytest.raises(ValueError):
        fp.arm("wal.fsync", "nosuchkind")
    fp.arm("ad.hoc", OSError, strict=False)
    with pytest.raises(OSError):
        fp.failpoint("ad.hoc")
    err = ValueError("boom")
    with fp.armed("delta.apply", err):
        with pytest.raises(ValueError) as got:
            fp.failpoint("delta.apply")
        assert got.value is err
        assert set(fp.list_armed()) == {"service.flush", "ad.hoc", "delta.apply"}
    fp.disarm_all()
    fp.failpoint("ad.hoc")  # disarmed: free no-op
    assert fp.SITES == ref_fp.SITES


def test_repro_failpoints_environment_arms_at_import():
    """``REPRO_FAILPOINTS`` arms sites when the module is imported, with the
    reference's grammar (kind, pP, nN, sS, seedX; ',' or ';' separated)."""
    spec = "service.flush=timeout:n2:s1; delta.apply=oserror:p0.25:seed4,tuner.swap"
    code = (
        "import json\n"
        "from repro_torch.fault import failpoints as fp\n"
        "out = []\n"
        "for _ in range(4):\n"
        "    try:\n"
        "        fp.failpoint('service.flush'); out.append(None)\n"
        "    except Exception as e:\n"
        "        out.append(type(e).__name__)\n"
        "print(json.dumps([out, fp.list_armed()], sort_keys=True))\n"
    )
    got = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), REPRO_FAILPOINTS=spec),
    )
    fired, armed = json.loads(got.stdout)
    assert fired == [None, "TimeoutError", "TimeoutError", None]
    assert armed["delta.apply"] == {"prob": 0.25, "remaining": None, "skip": 0}
    assert armed["tuner.swap"] == {"prob": 1.0, "remaining": None, "skip": 0}
    with pytest.raises(ValueError, match="bad REPRO_FAILPOINTS"):
        fp._arm_from_env("wal.fsync=oserror:q7")


def test_with_retries_matches_reference():
    def run(mod, fail_times):
        slept, seen = [], []
        left = [fail_times]

        def fn():
            if left[0]:
                left[0] -= 1
                raise OSError("transient")
            return "done"

        try:
            res = mod.with_retries(fn, attempts=4, rng=random.Random(1), sleep=slept.append,
                                   on_retry=lambda i, e: seen.append(i))
        except OSError:
            res = "failed"
        return res, slept, seen

    for fails in (0, 2, 4):
        assert run(ref_retry, fails) == run(retry, fails)
    assert run(retry, 4)[0] == "failed" and len(run(retry, 4)[1]) == 3
    assert list(retry.backoff_delays(5, jitter=0.0)) == [0.002, 0.004, 0.008, 0.016]
    with pytest.raises(KeyError):  # not in retry_on: no retry
        retry.with_retries(lambda: {}["x"], attempts=3, sleep=lambda s: None)
