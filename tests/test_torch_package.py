"""The PyTorch port's package: import hygiene, the numpy-only modules it
copies (qd-tree, predicates) against the reference, and the build plumbing
of its CUDA kernels."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.predicates import evaluate_filter as ref_evaluate_filter
from repro.core.qdtree import build_qdtree as ref_build_qdtree
from repro.core.workload import kg_style as ref_kg_style
from repro_torch.core.predicates import evaluate_filter
from repro_torch.core.qdtree import build_qdtree
from repro_torch.core.workload import kg_style
from repro_torch.kernels import _build

from conftest import small_db, small_workload

SRC = Path(__file__).resolve().parents[1] / "src"


def test_import_leaves_out_jax_and_reference():
    """Importing repro_torch and every submodule pulls in neither jax nor repro."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "n = sum(1 for m in sys.modules if m.startswith('repro_torch'))\n"
        "print(n, bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    n, bad = out.stdout.split(" ", 1)
    # every module of the package imported: one per .py file, __init__ files included
    files = sum(1 for _ in (SRC / "repro_torch").rglob("*.py"))
    assert int(n) == files, out.stdout
    assert bad.strip() == "[]", out.stdout


@pytest.mark.parametrize("package", ["repro_torch.service", "repro_torch.fault", "repro_torch.obs",
                                     "repro_torch.store", "repro_torch.tuner",
                                     "repro_torch.fault.chaos", "repro_torch.train.fault_tolerance",
                                     "repro_torch.launch.train", "repro_torch.data.pipeline",
                                     "repro_torch.distributed", "repro_torch.distributed.compression",
                                     "repro_torch.distributed.sharding", "repro_torch.launch.obsdump",
                                     "repro_torch.launch.dryrun", "repro_torch.launch.op_cost",
                                     "repro_torch.launch.report"])
def test_serving_packages_leave_out_jax_and_reference(package):
    """The online service, its host-only carry-overs (metrics, drift,
    failpoints, retry), the store, the tuner, the chaos harness, the train
    loop, the training CLI, the data pipeline, the data-parallel compression
    and sharding rules, the observability dump and the dry run's three
    tools import alone without jax or the reference package."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({package!r})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env=dict(os.environ, PYTHONPATH=str(SRC)),
    )
    assert out.stdout.strip() == "[]", out.stdout


def test_no_library_attention_or_compile_in_the_package():
    """The port's attention is its own kernel: no file of the package calls
    ``scaled_dot_product_attention`` or ``torch.compile``."""
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        text = path.read_text()
        assert "scaled_dot_product_attention" not in text, path
        assert "torch.compile" not in text, path


def _ref_db_workload():
    db = small_db()
    return db, small_workload(db)


@pytest.mark.parametrize("source", ["small_db", "kg_style"])
def test_qdtree_leaves_match_reference(source):
    """Same database and workload: the port's qd-tree has the reference's leaves."""
    if source == "small_db":
        db, wl = _ref_db_workload()
        kw = dict(min_size=128, max_leaves=32)
    else:
        kg = ref_kg_style(n=3000, d=16, queries_per_split=300, seed=0)
        db, wl = kg.db, kg.splits[0]
        kw = dict(min_size=64, max_leaves=64)
    a = ref_build_qdtree(db, wl, **kw)
    b = build_qdtree(db, wl, **kw)
    assert len(a.leaves) == len(b.leaves) > 1
    for la, lb in zip(a.leaves, b.leaves):
        assert np.array_equal(la.rows, lb.rows)
    for filt in wl.templates:
        assert np.array_equal(a.route_filter(filt), b.route_filter(filt))


def test_kg_style_and_filters_match_reference():
    """The copied generator and predicate evaluator give the reference's data."""
    a = ref_kg_style(n=2000, d=8, queries_per_split=50, seed=3)
    b = kg_style(n=2000, d=8, queries_per_split=50, seed=3)
    assert np.array_equal(a.db.vectors, b.db.vectors)
    for sa, sb in zip(a.splits, b.splits):
        assert np.array_equal(sa.vectors, sb.vectors)
        assert np.array_equal(sa.template_of, sb.template_of)
    for filt in a.templates:
        assert np.array_equal(ref_evaluate_filter(filt, a.db), evaluate_filter(filt, a.db))


def test_kernel_build_is_lazy():
    """Importing the kernels builds nothing: nvcc runs on first launch only."""
    assert _build._LIBS == {}
    assert _build.SOURCES == tuple(sorted(p.stem for p in _build.SRC_DIR.glob("*.cu")))


@pytest.mark.parametrize(
    "source,entry",
    [pytest.param(src, entry, id=entry)
     for src in sorted(_build.SIGNATURES) for entry in sorted(_build.SIGNATURES[src])],
)
def test_ctypes_signatures_match_source(source, entry):
    """Every bound C entry point of every source takes as many arguments, of
    the same kinds (pointer, float or int), as the .cu source declares."""
    src = (_build.SRC_DIR / f"{source}.cu").read_text()
    m = re.search(rf"int {entry}\(([^)]*)\)", src)
    assert m, entry
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = ["p" if "*" in p else "f" if p.startswith("float ") else "i" for p in params]
    kind_of = {_build._P: "p", _build._F: "f", _build._I: "i"}
    want = [kind_of[t] for t in _build.SIGNATURES[source][entry]]
    assert kinds == want


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited shared header (csrc/*.cuh) changes every library's build
    target, so the next launch rebuilds instead of loading a stale .so."""
    for f in _build.SRC_DIR.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    before = {n: _build._target(n) for n in _build.SOURCES}
    header = next(tmp_path.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)
