"""The port's kernel modules against the reference, on the CPU.

On a CPU tensor the ``fused_knn`` wrappers run their plain version, so these
tests hold that version (and the dispatch layer around it) against
``repro.kernels.fused_knn`` in interpret mode and ``repro.kernels.ref``; the
same inputs, made with seeded numpy, go to both packages. The CUDA kernels
are held against the same plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import kmeans as ref_kmeans
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.fused_knn import fused_knn as pallas_fused_knn
from repro.kernels.fused_knn import fused_knn_db_stationary as pallas_db_stationary
from repro_torch.core import kmeans
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_knn import (
    MAX_K,
    fused_knn,
    fused_knn_db_stationary,
    fused_knn_plain,
    kernel_passes,
)

SWEEP = [(5, 300, 32, 4), (130, 1000, 64, 10), (1, 7, 8, 3), (257, 129, 16, 5)]


def _inputs(seed, nq, nv, d, density=0.7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    v = rng.normal(size=(nv, d)).astype(np.float32)
    valid = rng.random(nv) < density
    return q, v, valid


def _port(fn, q, v, valid, k, metric, dtype=torch.float32):
    """Run a port wrapper on one work unit (W = 1) given numpy inputs."""
    s, i = fn(
        torch.from_numpy(q).to(dtype)[None], torch.from_numpy(v).to(dtype)[None],
        torch.from_numpy(valid)[None], k=k, metric=metric,
    )
    return s[0].float().numpy(), i[0].numpy()


def _assert_ids_untied(si, ii, sj, ij, tol):
    """Same ids wherever the reference score is untied (and the last slot is
    not, since it may tie with the first row left out); the same absent slots."""
    assert np.array_equal(ii < 0, ij < 0)
    for r in range(si.shape[0]):
        s = sj[r].astype(np.float64)
        for c in range(s.shape[0] - 1):
            near = [abs(s[c] - s[c2]) <= tol * (1 + abs(s[c])) for c2 in (c - 1, c + 1) if 0 <= c2 < len(s)]
            if ij[r, c] >= 0 and not any(near):
                assert ii[r, c] == ij[r, c], (r, c)


@pytest.mark.parametrize("nq,nv,d,k", SWEEP)
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid", ["fused_knn", "fused_knn_db_stationary"])
def test_fused_knn_matches_reference(nq, nv, d, k, metric, dtype, grid):
    """Both grids (plain version on the CPU) against ``ref.masked_topk_ref``:
    scores within 1e-4 (f32) or 2e-2 (bf16), ids equal where untied."""
    q, v, valid = _inputs(nq * 7 + nv, nq, nv, d)
    if dtype == "bfloat16":  # round the inputs to bf16 once, the same for both
        q = torch.from_numpy(q).bfloat16().float().numpy()
        v = torch.from_numpy(v).bfloat16().float().numpy()
    fn = fused_knn if grid == "fused_knn" else fused_knn_db_stationary
    s, i = _port(fn, q, v, valid, k, metric, getattr(torch, dtype))
    rs, ri = jref.masked_topk_ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(valid), k, metric)
    rs, ri = np.asarray(rs), np.asarray(ri)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(s, rs, rtol=tol, atol=tol)
    _assert_ids_untied(s, i, rs, ri, tol)


@pytest.mark.parametrize("nq,nv,d,k,metric", [(5, 300, 32, 4, "ip"), (100, 700, 16, 7, "l2")])
def test_fused_knn_matches_pallas_interpret(nq, nv, d, k, metric):
    """The port against the Pallas kernels themselves (interpret mode)."""
    q, v, valid = _inputs(11, nq, nv, d)
    s, i = _port(fused_knn, q, v, valid, k, metric)
    for pallas in (pallas_fused_knn, pallas_db_stationary):
        kw = dict(tq=32, tv=64) if pallas is pallas_db_stationary else {}
        ps, pi = pallas(jnp.asarray(q), jnp.asarray(v), jnp.asarray(valid), k=k, metric=metric,
                        interpret=True, **kw)
        np.testing.assert_allclose(s, np.asarray(ps), rtol=1e-4, atol=1e-4)
        _assert_ids_untied(s, i, np.asarray(ps), np.asarray(pi), 1e-4)


def test_unfilled_slots_are_absent_unlike_pallas():
    """Fewer valid rows than k, spread over several V tiles: the port follows
    ``masked_topk_ref`` ([700, 3, -1, -1]). The Pallas grids are the one place
    the reference differs: their ``_merge_topk`` re-selects a position it
    already knocked out to NEG_INF and returns its real index (ROADMAP.md §3,
    the sentinel leak: [700, 3, 3, 3]), so they are compared on the filled
    slots only."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 8)).astype(np.float32)
    v = rng.normal(size=(1024, 8)).astype(np.float32)
    v[700] = 3 * q[0]
    v[3] = q[0]
    valid = np.zeros(1024, bool)
    valid[[3, 700]] = True
    for fn in (fused_knn, fused_knn_db_stationary):
        s, i = _port(fn, q, v, valid, 4, "ip")
        assert i.tolist() == [[700, 3, -1, -1]]
        assert (s[0, 2:] == np.float32(ref.NEG_INF)).all()
    rs, ri = jref.masked_topk_ref(jnp.asarray(q), jnp.asarray(v), jnp.asarray(valid), 4, "ip")
    assert np.asarray(ri).tolist() == [[700, 3, -1, -1]]
    ps, pi = pallas_fused_knn(jnp.asarray(q), jnp.asarray(v), jnp.asarray(valid), k=4, interpret=True)
    assert np.asarray(pi)[0, :2].tolist() == [700, 3]  # filled slots agree


@pytest.mark.parametrize("grid", ["fused_knn", "fused_knn_db_stationary"])
def test_all_invalid_and_k_above_valid(grid):
    fn = fused_knn if grid == "fused_knn" else fused_knn_db_stationary
    q, v, _ = _inputs(2, 4, 300, 8)
    s, i = _port(fn, q, v, np.zeros(300, bool), 3, "ip")
    assert (i == -1).all() and (s == np.float32(ref.NEG_INF)).all()
    valid = np.zeros(300, bool)
    valid[[10, 200]] = True
    s, i = _port(fn, q, v, valid, 5, "l2")
    assert (i[:, 2:] == -1).all()
    assert all(set(row[:2].tolist()) == {10, 200} for row in i)


@pytest.mark.parametrize("tv", [48, 256])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_workunit_topk_matches_reference(tv, metric):
    """Batched units through both dispatch layers; TV=256 takes the split-V
    grid (TV >= 4·TQ), TV=48 the query-stationary one. Same shapes recorded."""
    rng = np.random.default_rng(tv)
    q = rng.normal(size=(3, 16, 12)).astype(np.float32)
    v = rng.normal(size=(3, tv, 12)).astype(np.float32)
    valid = rng.random((3, tv)) < 0.6
    ops.reset_dispatch_stats()
    ref_ops.reset_dispatch_stats()
    before = (fused_knn_plain.calls,)
    s, i = ops.workunit_topk(torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(valid), 6, metric=metric)
    rs, ri = ref_ops.workunit_topk(jnp.asarray(q), jnp.asarray(v), jnp.asarray(valid), 6, metric=metric, use_pallas=False)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-4, atol=1e-4)
    for w in range(3):
        _assert_ids_untied(s[w].numpy(), i[w].numpy(), np.asarray(rs[w]), np.asarray(ri[w]), 1e-4)
    assert ops.dispatch_stats().shapes == ref_ops.dispatch_stats().shapes
    assert fused_knn_plain.calls == before[0] + 1
    assert ops.use_db_stationary(16, tv) == (tv >= 64)


def _tied_scores(rng, shape, levels=4):
    """Scores drawn from a few values (many exact ties), with -inf padding."""
    s = rng.integers(0, levels, size=shape).astype(np.float32) - 2.0
    s[rng.random(shape) < 0.15] = -np.inf
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_topk_bit_identical(seed):
    rng = np.random.default_rng(seed)
    s = _tied_scores(rng, (9, 32))
    i = rng.integers(-1, 500, size=(9, 32)).astype(np.int64)
    a_s, a_i = ops.merge_topk(torch.from_numpy(s), torch.from_numpy(i), 7)
    b_s, b_i = ref_ops.merge_topk(jnp.asarray(s), jnp.asarray(i), 7)
    assert np.array_equal(a_s.numpy(), np.asarray(b_s))
    assert np.array_equal(a_i.numpy(), np.asarray(b_i))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_merge_topk_bit_identical(seed):
    """Ragged segments, tie-heavy scores, and padding rows (seg_of >= m) that
    must be dropped."""
    rng = np.random.default_rng(seed)
    m, C, kk, k = 6, 40, 5, 4
    seg = np.sort(rng.integers(0, m + 1, size=C)).astype(np.int32)  # value m = padding
    s = _tied_scores(rng, (C, kk))
    i = rng.integers(-1, 900, size=(C, kk)).astype(np.int64)
    a_s, a_i = ops.segmented_merge_topk(torch.from_numpy(s), torch.from_numpy(i), torch.from_numpy(seg), m, k)
    b_s, b_i = ref_ops.segmented_merge_topk(jnp.asarray(s), jnp.asarray(i), jnp.asarray(seg), m, k)
    assert np.array_equal(a_s.numpy(), np.asarray(b_s))
    assert np.array_equal(a_i.numpy(), np.asarray(b_i))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_topm_centroids_bit_identical(metric):
    """Integer-valued vectors make the products exact, so scores tie exactly;
    the smaller centroid id must win, as with ``lax.top_k``."""
    rng = np.random.default_rng(3)
    q = rng.integers(-2, 3, size=(20, 4)).astype(np.float32)
    c = rng.integers(-2, 3, size=(12, 4)).astype(np.float32)
    c[5] = c[2]
    c[9] = c[2]
    a = kmeans.topm_centroids(q, c, 6, metric=metric, device="cpu")
    b = ref_kmeans.topm_centroids(q, c, 6, metric=metric)
    assert np.array_equal(a, b)


def test_stable_topk_tie_fallback():
    """``stable_topk`` over long rows (the ``torch.topk`` path) ranks ties by
    index, as a stable sort does, and matches the reference oracle."""
    rng = np.random.default_rng(9)
    s = rng.integers(0, 3, size=(5, 400)).astype(np.float32)
    s[1] = rng.normal(size=400).astype(np.float32)  # an untied row
    top, idx = ref.stable_topk(torch.from_numpy(s), 8)
    want = np.argsort(-s, axis=1, kind="stable")[:, :8]
    assert np.array_equal(idx.numpy(), want)
    assert np.array_equal(top.numpy(), np.take_along_axis(s, want, axis=1))


def test_normalize_and_pairwise_match_reference():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(6, 8)).astype(np.float32)
    s[0, 3] = -np.inf
    s[2, 1] = ref.NEG_INF
    i = rng.integers(-1, 9, size=(6, 8)).astype(np.int64)
    a = ref.normalize_merge_sentinels(torch.from_numpy(s), torch.from_numpy(i))
    b = jref.normalize_merge_sentinels(jnp.asarray(s), jnp.asarray(i))
    assert np.array_equal(a[0].numpy(), np.asarray(b[0]))
    assert np.array_equal(a[1].numpy(), np.asarray(b[1]))
    q, v = rng.normal(size=(5, 16)).astype(np.float32), rng.normal(size=(7, 16)).astype(np.float32)
    for metric in ("ip", "l2"):
        np.testing.assert_allclose(
            ops.pairwise_scores(torch.from_numpy(q), torch.from_numpy(v), metric).numpy(),
            np.asarray(jref.pairwise_scores_ref(jnp.asarray(q), jnp.asarray(v), metric)),
            rtol=1e-5, atol=1e-5,
        )


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((2, 4, 8))
    v = torch.zeros((2, 16, 8))
    valid = torch.ones((2, 16), dtype=torch.bool)
    with pytest.raises(ValueError):
        fused_knn(q, v[:1], valid, k=2)
    with pytest.raises(TypeError):
        fused_knn(q, v.double(), valid, k=2)
    with pytest.raises(TypeError):
        fused_knn(q, v, valid.int(), k=2)
    with pytest.raises(ValueError):
        fused_knn(q, v, valid, k=17)
    with pytest.raises(ValueError):
        fused_knn_db_stationary(q, v, valid, k=2, metric="cos")


@pytest.mark.parametrize(
    "k,d,tq,passes",
    [(10, 64, 64, 1), (MAX_K, 453, 64, 1), (MAX_K + 1, 64, 64, 2),
     (10, 454, 64, 1), (10, 768, 64, 1), (10, 1024, 64, 1), (400, 64, 1, 7)],
)
def test_kernel_limits(k, d, tq, passes):
    """The CUDA kernels take every k, d and TQ: D is staged in 64-element
    chunks, and a k above the lists' ``MAX_K`` takes ``kernel_passes(k)``
    launches of at most ``MAX_K`` entries (``floor_passes``). The plain
    version on the CPU answers the same shapes in one call."""
    assert kernel_passes(k) == passes
    q = torch.zeros((1, tq, d))
    v = torch.zeros((1, k + 1, d))
    s, i = fused_knn(q, v, torch.ones((1, k + 1), dtype=torch.bool), k=k)
    assert s.shape == i.shape == (1, tq, k)
