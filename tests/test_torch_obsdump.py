"""The port's observability dump (``repro_torch.launch.obsdump``) against the
reference's (``repro.launch.obsdump``), both on the CPU at ``--n 2000
--queries 60 --tune``: the same sections and keys, every submitted query
answered on both, the same metric names, the same templates flagged by the
drift report, the same swap record size, and a valid trace with the same
span names on both."""
import json

import numpy as np
import pytest

from repro.core.workload import kg_style as ref_kg_style
from repro.launch import obsdump as ref_obsdump
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro_torch.launch import obsdump
from repro_torch.obs import metrics
from repro_torch.obs import trace

ARGS = ["--n", "2000", "--queries", "60", "--tune"]


def _sections(text):
    """``== name ==`` headed sections of a dump's standard output: JSON where
    the body parses, else the raw text."""
    out, name, body = {}, None, []
    for line in text.splitlines():
        if line.startswith("== ") and line.endswith(" =="):
            if name is not None:
                out[name] = "\n".join(body)
            name, body = line[3:-3], []
        elif name is not None:
            body.append(line)
    out[name] = "\n".join(body)
    for k, v in out.items():
        try:
            out[k] = json.loads(v)
        except ValueError:
            pass
    return out


def _shape(metric_snapshot):
    """Metric names, with the keys of every dict-valued metric."""
    return {name: sorted(v) if isinstance(v, dict) else None for name, v in metric_snapshot.items()}


def _flagged(drift, shift=0.05):
    """Templates whose share moved by more than ``shift`` between the older
    and the recent half of the window."""
    keys = set(drift["template_shares"]) | set(drift["reference_shares"])
    return {k for k in keys
            if abs(drift["template_shares"].get(k, 0.0) - drift["reference_shares"].get(k, 0.0)) > shift}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(port's printed sections, port's returned record, reference's sections,
    both traces), each run with a fresh metrics registry."""
    import contextlib
    import io
    import sys

    tmp = tmp_path_factory.mktemp("obsdump")
    metrics.set_registry(None)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        record = obsdump.main(ARGS + ["--device", "cpu", "--trace-out", str(tmp / "port.json")])
    port = _sections(buf.getvalue())

    ref_metrics.set_registry(None)
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["obsdump"] + ARGS + ["--trace-out", str(tmp / "ref.json")]
    try:
        with contextlib.redirect_stdout(buf):
            ref_obsdump.main()
    finally:
        sys.argv = argv
    ref = _sections(buf.getvalue())
    traces = [json.loads((tmp / f"{n}.json").read_text()) for n in ("port", "ref")]
    return port, record, ref, traces


def test_sections_and_keys_match_reference(dumps):
    port, record, ref, _ = dumps
    assert list(port) == list(ref) == ["health", "metrics", "drift", "tuner", "trace"]
    for name in ("health", "drift", "tuner"):
        assert sorted(port[name]) == sorted(ref[name]), name
        assert record[name] == port[name]


def test_every_submitted_query_answered_as_in_reference(dumps):
    port, record, ref, _ = dumps
    wl = ref_kg_style(n=2000, d=16, queries_per_split=60, seed=0).splits[0]
    tcut = max(1, len(wl.templates) // 2)
    low = int((wl.template_of < tcut).sum())
    submitted = wl.m if 0 < low < wl.m else 2 * wl.m
    assert record["submitted"] == record["answered"] == submitted
    for dump in (port, ref):
        assert dump["metrics"]["service"]["queries"] == submitted
        assert dump["metrics"]["service"]["failed_queries"] == dump["metrics"]["service"]["rejected"] == 0
        assert dump["health"]["queue_depth"] == 0


def test_metric_names_match_reference(dumps):
    port, _, ref, _ = dumps
    assert _shape(port["metrics"]) == _shape(ref["metrics"])


def test_drift_flags_the_reference_templates(dumps):
    port, _, ref, _ = dumps
    assert _flagged(port["drift"]) == _flagged(ref["drift"]) != set()
    assert port["drift"]["share_shift"] == pytest.approx(ref["drift"]["share_shift"])
    assert port["drift"]["n_window"] == ref["drift"]["n_window"]


def test_swap_record_matches_reference(dumps):
    port, _, ref, _ = dumps
    for key in ("n_rows", "reason", "generation", "index_swaps", "rollback_armed"):
        assert port["tuner"][key] == ref["tuner"][key], key
    assert port["tuner"]["n_rows"] == 2000 + 20  # rows after the insert (deleted rows stay as dead rows)


def test_trace_valid_with_the_reference_span_names(dumps):
    port, record, _, (doc, ref_doc) = dumps
    assert trace.validate_chrome_trace(doc) > 0 and ref_trace.validate_chrome_trace(ref_doc) > 0
    names = lambda d: sorted({e["name"] for e in d["traceEvents"] if e.get("ph") == "X"})
    assert names(doc) == names(ref_doc) == record["trace"]["span_names"]
    assert f"{record['trace']['events']} events" in port["trace"]


def test_obsdump_on_cuda_without_a_card_raises(tmp_path):
    """No fallback: without a card the default device raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        obsdump.main(["--n", "500", "--queries", "10", "--trace-out", str(tmp_path / "t.json")])
    np.testing.assert_equal(trace.get_tracer().span_count, 0)


def test_obsdump_removes_its_directory_when_the_service_fails(tmp_path, monkeypatch):
    """The WAL and tuner directory goes even when building the service
    raises."""
    import tempfile

    def refuse(*a, **kw):
        raise RuntimeError("no service")

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(obsdump, "HQIService", refuse)
    with pytest.raises(RuntimeError, match="no service"):
        obsdump.main(["--n", "500", "--queries", "10", "--device", "cpu",
                      "--trace-out", str(tmp_path / "t.json")])
    assert not list(tmp_path.glob("obsdump_*"))
