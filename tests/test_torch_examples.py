"""The port's examples (``examples/torch_*.py``) on the CPU: each run through
``runpy`` in a fresh interpreter with ``--device cpu`` (and ``--tiny``
where it has one) prints "OK" and imports neither jax nor the reference
package; without ``--device cpu`` each raises on a machine with no card
(no fallback). Plus the two ``HQIIndex`` statistics the quickstart prints,
against the reference's."""
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import HQIConfig as RefHQIConfig
from repro.core import HQIIndex as RefHQIIndex
from repro.core.workload import kg_style as ref_kg_style
from repro_torch.core import HQIIndex
from repro_torch.core.workload import kg_style

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "link_prediction", "online_serving", "index_evolution",
            "distributed_search", "train_lm", "related_queries"]
TINY = {"link_prediction", "distributed_search", "train_lm"}  # the examples with a --tiny size


def test_every_example_has_a_port():
    """One ``torch_`` example for each of the reference's."""
    ref = sorted(p.stem for p in (ROOT / "examples").glob("*.py") if not p.stem.startswith("torch_"))
    port = sorted(p.stem[len("torch_"):] for p in (ROOT / "examples").glob("torch_*.py"))
    assert ref == port == sorted(EXAMPLES)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu_without_jax(name, tmp_path):
    path = ROOT / "examples" / f"torch_{name}.py"
    argv = [str(path), "--device", "cpu"] + (["--tiny"] if name in TINY else [])
    code = (
        "import runpy, sys\n"
        f"sys.argv = {argv!r}\n"
        f"runpy.run_path({str(path)!r}, run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('imported:', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "imported: []", out.stdout
    assert lines[-2].startswith("OK"), out.stdout


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_raises(name, monkeypatch, tmp_path):
    """Its default device is the card: with none, it raises before any answer."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [f"torch_{name}.py"] + (["--tiny"] if name in TINY else []))
    with pytest.raises((RuntimeError, AssertionError, ValueError)) as err:
        runpy.run_path(str(ROOT / "examples" / f"torch_{name}.py"), run_name="__main__")
    msg = str(err.value).lower()
    assert "cuda" in msg or "card" in msg, msg


def test_partition_stats_match_reference():
    """``partition_sizes`` and ``tuples_routed`` (the Eq. (1) cost) equal the
    reference's on the same index (loaded from its ``to_state()``), each
    package routing its own generator's workload (the same arrays)."""
    ref_kg = ref_kg_style(n=3000, d=16, queries_per_split=100, seed=0)
    kg = kg_style(n=3000, d=16, queries_per_split=100, seed=0)
    ref = RefHQIIndex.build(ref_kg.db, ref_kg.splits[0], RefHQIConfig(min_partition_size=128, max_leaves=32))
    idx = HQIIndex.from_state(ref.to_state(), device="cpu")
    np.testing.assert_array_equal(idx.partition_sizes(), ref.partition_sizes())
    for ref_wl, wl in zip(ref_kg.splits, kg.splits):
        assert idx.tuples_routed(wl) == ref.tuples_routed(ref_wl) > 0
