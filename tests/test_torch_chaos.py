"""The port's chaos harness on the CPU, at its ``--smoke`` size and at the
reference's configuration (4 rounds of 50 queries): seeded
faults at the WAL, delta, flush, tick, snapshot and compaction sites, an
fsync poisoning round and a SIGKILLed writer subprocess, holding the three
invariants of ``tests/test_fault.py::test_chaos_invariants`` (no lost
acknowledged write, no hung query, exact parity on non-degraded answers)
against the port's ``exhaustive_search``. The writer is killed only after
its first acknowledgement, so the kill check covers real acknowledged ids.
"""
import dataclasses

from repro_torch.fault.chaos import ChaosConfig, main, run_chaos


def test_chaos_invariants(tmp_path):
    cfg = dataclasses.replace(
        ChaosConfig(seed=0, device="cpu"),
        rounds=2, queries_per_round=25, writes_per_round=4, n0=800, poison_rounds=(1,),
    )  # the CLI's --smoke configuration
    rep = run_chaos(str(tmp_path), cfg)
    assert rep.ok, rep.as_dict()
    assert rep.queries_submitted == cfg.rounds * cfg.queries_per_round
    assert rep.answered_ok > 0 and rep.writes_acked > 0
    assert rep.recovery_checks >= 1
    assert rep.hung == 0
    assert rep.parity_mismatches == 0
    assert rep.recovery_violations == 0
    assert rep.killed_writers == 1 and rep.killed_writer_acks > 0
    assert len(rep.sites_fired) >= 5, rep.sites_fired
    assert "wal.fsync" in rep.sites_fired
    assert "service.flush" in rep.sites_fired


def test_chaos_invariants_at_the_reference_configuration(tmp_path):
    """The reference's own configuration (``tests/test_fault.py::
    test_chaos_invariants``: 4 rounds of 50 queries, the rest of
    ``ChaosConfig``'s defaults) with every assertion of that test, plus
    acknowledged ids from the killed writer."""
    cfg = ChaosConfig(seed=0, rounds=4, queries_per_round=50, device="cpu")
    rep = run_chaos(str(tmp_path), cfg)
    assert rep.ok, rep.as_dict()
    assert rep.queries_submitted >= 200
    assert rep.answered_ok > 0 and rep.writes_acked > 0
    assert rep.recovery_checks >= 1
    assert rep.hung == 0
    assert rep.parity_mismatches == 0
    assert rep.recovery_violations == 0
    assert len(rep.sites_fired) >= 5, rep.sites_fired
    assert "wal.fsync" in rep.sites_fired
    assert "service.flush" in rep.sites_fired
    assert rep.killed_writers == 1 and rep.killed_writer_acks > 0


def test_chaos_cli_smoke_report(tmp_path, capsys):
    """``python -m repro_torch.fault.chaos --smoke --device cpu --no-kill``:
    a JSON report on stdout, exit code 0 when every invariant held."""
    import json

    assert main(["--smoke", "--device", "cpu", "--no-kill", "--root", str(tmp_path)]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["hung"] == 0 and rep["killed_writers"] == 0
