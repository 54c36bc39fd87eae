"""PR-22 arithmetic and decompositions, on the CPU.

  * ``ref.fmaf`` against an exact oracle (``fractions.Fraction``), on seeded
    draws and on a case where rounding to fp64 first rounds twice;
  * ``fused_knn_plain`` (the f32 scan kernels' plain version) against a
    pure-Python ``fmaf`` chain over c = 0 … D-1, bit for bit, ip and l2;
  * the decomposition of ``adc_wide_m_kernel`` (``csrc/pq_scan.cu``) as a
    pure-Python stand-in for each launch of ``pq_scan.adc_wide_m``: a block
    owns one LUT row and a tile of rows, the row's 48-subspace slices outside
    the row loop, rows in tiles of g·256 over g warps, the g lists folded,
    ``pq_scan``'s row ranges folded by the last block; bit for bit against
    the plain versions at k′ 40, 80 and 400;
  * the decomposition of ``flash_sliced_kernel`` (``csrc/flash_attention.cu``):
    the logits summed over dh in 32-column slices, O in column slices of a
    block each; within ``ATTN_TOL`` of the plain version and of the Pallas
    kernel in interpret mode at dh 320.
"""
import importlib.util
import random
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_knn as fk
from repro_torch.kernels import pq_scan as ps
from repro_torch.kernels import ref

NEG_INF = ref.NEG_INF
ROOT = Path(__file__).resolve().parents[1]


def _attn_tol():
    """``chip_smoke.py``'s ATTN_TOL, the limits the card holds the kernels to."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.ATTN_TOL


# ------------------------------------------------------------ fmaf, exactly


def _round_f32(x: Fraction) -> np.float32:
    """The fp32 nearest x, ties to even (``float(x)`` is the nearest fp64,
    within one fp32 ulp of the answer, so the answer is it or a neighbour)."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x), int(np.float32(y).view(np.uint32)) & 1))


def _fmaf_exact(a, b, c) -> np.float32:
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


@pytest.mark.parametrize("scale", [1.0, 1e-6, 1e6])
def test_fmaf_matches_exact_oracle(scale):
    """``ref.fmaf`` is ``a·b + c`` rounded once: equal to the Fraction
    oracle on seeded draws, c at several scales against a·b (so that the sum
    lands near fp32 midpoints often), subnormal and cancelling cases included."""
    rng = np.random.default_rng(int(scale * 7) + 3)
    n = 700
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * scale).astype(np.float32)
    c[:50] = -(a[:50].astype(np.float64) * b[:50]).astype(np.float32)  # near-total cancellation
    a[50:60] = np.float32(1e-40)  # subnormal products and sums
    c[50:60] = np.float32(3e-41)
    got = ref.fmaf(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_fmaf_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fmaf_is_not_fp64_double_rounding():
    """a = b = 1 + 2⁻¹², c = 2⁻⁸⁰: a·b + c is just above a midpoint of two
    fp32 values; rounded to fp64 it lands on the midpoint and then rounds
    down to even. ``ref.fmaf`` rounds up, as the oracle does."""
    a = np.float32(1 + 2.0**-12)
    c = np.float32(2.0**-80)
    t = torch.tensor([a])
    got = ref.fmaf(t, t, torch.tensor([c])).item()
    naive = float((t.double() * t.double() + torch.tensor([c]).double()).float())
    want = float(_fmaf_exact(a, a, c))
    assert got == want and naive != want


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_knn_plain_is_an_fmaf_chain(metric, dtype):
    """The plain version's scores are the kernels' chains bit for bit:
    ip = fmaf(q[c], v[c], ip) from 0 over c = 0 … D-1 (bf16 widened first),
    l2 = (2·ip − ‖q‖²) − ‖v‖² with the norms as chains of the same kind."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((1, 2, 24)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((1, 5, 24)).astype(np.float32)).to(dtype)
    v[0, 3] = v[0, 1]  # a tie
    valid = torch.ones((1, 5), dtype=torch.bool)
    s, i = fk.fused_knn_plain(q, v, valid, k=5, metric=metric)
    qf, vf = q.float().numpy()[0], v.float().numpy()[0]

    def chain(x, y):
        acc = np.float32(0)
        for c in range(x.shape[0]):
            acc = _fmaf_exact(x[c], y[c], acc)
        return acc

    for t in range(2):
        want = []
        for r in range(5):
            sc = chain(qf[t], vf[r])
            if metric == "l2":
                sc = np.float32(np.float32(np.float32(2) * sc - chain(qf[t], qf[t])) - chain(vf[r], vf[r]))
            want.append((sc, r))
        want.sort(key=lambda e: (-float(e[0]), e[1]))
        assert [float(x) for x in s[0, t]] == [float(e[0]) for e in want]
        assert i[0, t].tolist() == [e[1] for e in want]


# ------------------------------------------- adc_wide_m_kernel, emulated

_WARPS, _R, _MS = ps._WIDE_WARPS, ps._WIDE_ROWS_PER_LANE, ps._WIDE_SLICE


class _Sel:
    """A warp's list: the k best (score, row) under (score desc, row asc)
    among the candidates it admits (strictly after the floor, if any)."""

    def __init__(self, k, floor=None):
        self.k, self.floor, self.items = k, floor, []

    def offer(self, s, r):
        if self.floor is not None:
            fs, fi = self.floor
            if not (fi >= 0 and (s < fs or (s == fs and r > fi))):
                return
        self.items.append((float(s), int(r)))

    def top(self):
        return sorted(self.items, key=lambda e: (-e[0], e[1]))[:self.k]


def _scan_rows(lut, codes, valid, lo, hi, g, mem, sel):
    """``scan_rows`` for one warp: rows in tiles of g·256, the warp's rows
    r0 + (i·g + mem)·32 + lane; each tile's sums built slice by slice (the
    slice loop outside the row loop), m = 0 … M-1 in fp32."""
    M = lut.shape[0]
    for r0 in range(lo, hi, g * 32 * _R):
        rows = np.array([r0 + (i * g + mem) * 32 + lane for i in range(_R) for lane in range(32)])
        rows = rows[rows < hi]
        rows = rows[valid[rows]]
        acc = np.zeros(len(rows), np.float32)
        for m0 in range(0, M, _MS):
            for m in range(m0, min(M, m0 + _MS)):
                acc = acc + lut[m, codes[rows, m]]
        for s, r in zip(acc, rows):
            sel.offer(s, r)


def _fold(sels, k):
    """The lists of a group of warps folded into one."""
    out = _Sel(k)
    for s in sels:
        out.items.extend(s.top())
    return out.top()


def _write(entries, k):
    s = [e[0] for e in entries] + [NEG_INF] * (k - len(entries))
    i = [(-1 if e[0] <= NEG_INF / 2 else e[1]) for e in entries] + [-1] * (k - len(entries))
    return s, i


def _wide_emulated_pass(calls):
    """A stand-in for ``pq_scan._wide_pass``: the kernel's three modes on
    the CPU, with the kernel's work split (``wide_m_launch_shape``,
    ``slot_order``, ``row_blocks`` at 132 SMs)."""

    def run(lut, codes, valid, k, floor, *, idx=None, n_live=None):
        W, TV, M = codes.shape
        cn, vn = codes.numpy(), valid.numpy()
        fl = None if floor is None else (floor[0].reshape(-1).tolist(), floor[1].reshape(-1).tolist())
        floor_of = (lambda slot: None) if fl is None else (lambda slot: (fl[0][slot], fl[1][slot]))
        if idx is not None:
            TQ, mode = idx.shape[1], "units"
        else:
            TQ = lut.shape[1]
            mode = "rows" if W * TQ == 1 and n_live is None else "dense"
        calls.append(mode)
        out_s = np.full((W * TQ, k), NEG_INF, np.float32)
        out_i = np.full((W * TQ, k), -1, np.int32)
        if mode == "rows":
            G = ps.row_blocks(TV, 132)
            if fl is not None and fl[1][0] < 0:
                return torch.from_numpy(out_s).reshape(W, TQ, k), torch.from_numpy(out_i).reshape(W, TQ, k)
            parts = []
            for b in range(G):
                lo, hi = TV * b // G, TV * (b + 1) // G
                sels = [_Sel(k, floor_of(0)) for _ in range(_WARPS)]
                for warp in range(_WARPS):
                    _scan_rows(lut.numpy()[0, 0], cn[0], vn[0], lo, hi, _WARPS, warp, sels[warp])
                parts.append(_fold(sels, k))
            random.Random(len(parts)).shuffle(parts)  # the last block takes them as they come
            out_s[0], out_i[0] = _write(_fold([_from(p, k) for p in parts], k), k)
        else:
            _, _, _, P, g, _ = ps.wide_m_launch_shape(W, TQ, TV, dense=mode == "dense")
            if mode == "units":
                keys, order = (x.tolist() for x in ps.slot_order(idx))
                U = lut.shape[0]
            for b in range(-(-W * TQ // P)):  # the items, in any order of the blocks that walk them
                if mode == "units":
                    pos = range(b * P, min(W * TQ, b * P + P))
                    slots = [order[p] for p in pos]
                    rows = [-1 if keys[p] == -1 else min(max(keys[p], 0), U - 1) for p in pos]
                else:
                    slots = [b]
                    w, t = divmod(b, TQ)
                    rows = [b if (n_live is None or t < int(n_live[w])) else -1]
                rows = [-1 if (fl is not None and fl[1][sl] < 0) else r for r, sl in zip(rows, slots)]
                r0 = 0
                while r0 < len(rows):
                    r1 = r0 + 1
                    while r1 < len(rows) and rows[r1] == rows[r0]:
                        r1 += 1
                    if rows[r0] >= 0:
                        lut_row = lut.numpy().reshape(-1, M, 256)[rows[r0]]
                        for p in range(r1 - r0):
                            slot = slots[r0 + p]
                            w = slot // TQ
                            sels = [_Sel(k, floor_of(slot)) for _ in range(g)]
                            for mem in range(g):
                                _scan_rows(lut_row, cn[w], vn[w], 0, TV, g, mem, sels[mem])
                            out_s[slot], out_i[slot] = _write(_fold(sels, k), k)
                        assert r1 - r0 <= P
                    r0 = r1
        return torch.from_numpy(out_s).reshape(W, TQ, k), torch.from_numpy(out_i).reshape(W, TQ, k)

    return run


def _from(entries, k):
    s = _Sel(k)
    s.items = list(entries)
    return s


def _wide_case(seed, w, tq, tv, m, u=5):
    """A resident table with a duplicated row, slots with -1 and repeated
    rows, codes with tied rows, a mask with a short unit."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(u, m, 256)).astype(np.float32))
    table[1] = table[0]
    lut_idx = torch.from_numpy(rng.integers(0, u, (w, tq)).astype(np.int32))
    lut_idx[:, -1] = -1
    lut_idx[0, :3] = 2  # a run longer than a block's P where P < 4
    codes = torch.from_numpy(rng.integers(0, 256, (w, tv, m)).astype(np.uint8))
    codes[:, 50:90] = codes[:, :40]
    valid = torch.from_numpy(rng.random((w, tv)) < 0.8)
    valid[0, 30:] = False
    return table, lut_idx, codes, valid


@pytest.mark.parametrize("k", [40, 80, 400])
@pytest.mark.parametrize("mode", ["units", "dense", "rows"])
@pytest.mark.parametrize("tv,m", [(450, 67), (700, 33), (2300, 37)])
def test_wide_m_decomposition_is_bit_exact(k, mode, tv, m, monkeypatch):
    """``adc_wide_m`` with each launch replaced by the kernel's
    decomposition (one tile at TV 450, g 2 at 700 with P 4 slots a block,
    two tiles of 2048 rows at 2300; M of 2 and 3 slices, odd) equals the
    plain versions bit for bit, ties and short slots included, at k′ 40,
    80 and 400 (floor passes)."""
    if k > tv:
        pytest.skip("k′ above the unit's rows")
    table, lut_idx, codes, valid = _wide_case(k + tv + m, 2, 5, tv, m)
    calls = []
    monkeypatch.setattr(ps, "_wide_pass", _wide_emulated_pass(calls))
    if mode == "units":
        got = ps.adc_wide_m(table, codes, valid, k=k, lut_idx=lut_idx)
        want = ps.workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k)
    elif mode == "dense":
        luts = table[lut_idx.clamp(min=0).long()].contiguous()
        n_live = torch.tensor([5, 2], dtype=torch.int32)
        got = ps.adc_wide_m(luts, codes, valid, k=k, n_live=n_live)
        want = ps.workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
    else:
        got = ps.adc_wide_m(table[2][None, None], codes[1:], valid[1:], k=k)
        want = ps.pq_scan_plain(table[2], codes[1], valid[1], k=k)
        want = (want[0][None, None], want[1][None, None])
    assert calls == [mode] * fk.kernel_passes(k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------- flash_sliced_kernel, emulated


def _sliced_kernel_emulation(q, k, v, *, causal, window):
    """``flash_sliced_kernel``'s decomposition in f32: a block per (64 query
    rows, head, two halves of ``sliced_cols(dh)`` columns); per 64-key tile
    of the block's band the logits summed over dh 32 columns at a time
    ((q·scale) · k), masked to -3e38, one online-softmax update (p = 0 where
    masked), then O += P · V over the block's columns only; o = acc /
    max(l, 1e-30)."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = torch.tensor(dh**-0.5, dtype=torch.float32)
    dv = 2 * fa.sliced_cols(dh)  # a block's columns
    out = torch.zeros((b, s, hq, dh), dtype=torch.float32)
    for h in range(hq):
        hk = h // (hq // hkv)
        for q0 in range(0, s, 64):
            rows = min(64, s - q0)
            qpos = torch.arange(q0, q0 + 64)
            lo = max(0, q0 - window + 1) if window > 0 else 0
            hi = min(t, q0 + rows) if causal else t
            for c0 in range(0, dh, dv):
                m = torch.full((b, 64), -3.0e38)
                l = torch.zeros((b, 64))
                acc = torch.zeros((b, 64, dv))
                for t0 in range((lo // 64) * 64, hi, 64):
                    n = min(64, t - t0)
                    sc = torch.zeros((b, 64, 64))
                    for d0 in range(0, dh, 32):
                        qt = torch.zeros((b, 64, 32))
                        kt = torch.zeros((b, 64, 32))
                        w = min(32, dh - d0)
                        qt[:, :rows, :w] = q[:, q0:q0 + rows, h, d0:d0 + w].float() * scale
                        kt[:, :n, :w] = k[:, t0:t0 + n, hk, d0:d0 + w].float()
                        sc = sc + torch.einsum("bqd,bkd->bqk", qt, kt)
                    kpos = torch.arange(t0, t0 + 64)
                    keep = (kpos[None, :] < t).expand(64, 64)
                    if causal:
                        keep = keep & (kpos[None, :] <= qpos[:, None])
                    if window > 0:
                        keep = keep & (kpos[None, :] > qpos[:, None] - window)
                    sc = sc.masked_fill(~keep, -3.0e38)
                    m_new = torch.maximum(m, sc.amax(-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[..., None]).masked_fill(~keep, 0.0)
                    l = l * alpha + p.sum(-1)
                    vt = torch.zeros((b, 64, dv))
                    cw = min(dv, dh - c0)
                    vt[:, :n, :cw] = v[:, t0:t0 + n, hk, c0:c0 + cw].float()
                    acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, vt)
                    m = m_new
                res = acc / l.clamp_min(1e-30)[..., None]
                out[:, q0:q0 + rows, h, c0:c0 + dv] = res[:, :rows, :min(dv, dh - c0)]
    return out


@pytest.mark.parametrize("dh,s,t,window", [(320, 70, 70, 0), (520, 80, 130, 24), (288, 130, 70, 0)])
def test_sliced_attention_within_attn_tol(dh, s, t, window):
    """The f32 sliced kernel's decomposition (dh 320 and 288: one block of
    two 160-column halves; dh 520: two blocks of 2 x 160; S ≠ T, a window)
    stays within ``ATTN_TOL`` of the plain version."""
    rng = np.random.default_rng(dh + s)
    q = torch.from_numpy(rng.normal(size=(1, s, 2, dh)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, t, 1, dh)).astype(np.float32)) for _ in range(2))
    got = _sliced_kernel_emulation(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    rtol, atol, rel_tol = _attn_tol()[4]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= rel_tol


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_sliced_attention_at_dh320_matches_pallas(causal, window):
    """At dh 320 (one block of two column halves, ten 32-column logit slices) the
    decomposition against ``flash_attention_pallas`` in interpret mode."""
    rng = np.random.default_rng(321 + window)
    q = rng.normal(size=(1, 24, 2, 320)).astype(np.float32)
    k, v = (rng.normal(size=(1, 24, 1, 320)).astype(np.float32) for _ in range(2))
    got = _sliced_kernel_emulation(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                  window=window, bq=8, bk=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)
