"""The f32 attention forward's 3xTF32 design, emulated on the CPU.

``csrc/flash_attention.cu``'s ``flash_fwd_tf32x3_kernel`` cannot run here,
so its decomposition is written out in plain torch
(``_tf32x3_forward_emulation``) and held against ``flash_attention_plain``
within ``chip_smoke.ATTN_TOL[4]`` (its lse within ``LSE_TOL[4]``) and
against the reference's Pallas kernel in interpret mode: dh padded to a
multiple of 8, then zero to the compiled width DH; blocks of 64·MT query
rows in four row groups of 16·MT; key tiles of BN over the block's band,
the two warps of a row group taking BN/2 keys each; per warp S =
(q·scale)·Kᵀ as three TF32 products a k8 step (``torch_tf32.mm3``) summed
in SACC chains, the mask, its own online softmax in log2 units, and O =
O·alpha + P·V with each tile's P·V summed from zero in the permuted key
order; the two halves merged at the end, lse = (m + log2 l)·ln 2.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from torch_tf32 import mm3, permuted

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# FwdTile of csrc/flash_attention.cu by compiled width DH: m16 tiles a warp (a
# block's four row groups hold 64 x that query rows), keys a K/V tile (the two
# warps of a row group take half each), and the chains S's k8 steps are summed in
FWD_TILE = {32: (1, 64, 1), 64: (2, 64, 1), 128: (1, 64, 1), 256: (1, 16, 4)}


@functools.lru_cache(maxsize=1)
def _smoke():
    """``chip_smoke.py`` (its ATTN_TOL and LSE_TOL: the card's limits)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _rows(x, r0, n):
    """Rows r0 .. r0 + n of x [B, H, L, W] along dim 2, zero past L (as the
    zero-filled cp.async copies land them)."""
    out = torch.zeros(x.shape[:2] + (n,) + x.shape[3:], dtype=torch.float32)
    m = max(0, min(n, x.shape[2] - r0))
    out[:, :, :m] = x[:, :, r0:r0 + m]
    return out


def _s_chains(qb, kt, sacc):
    """S = qb·ktᵀ as the kernel's ``qk_products``: the k8 steps dealt
    round-robin to ``sacc`` chains, each a 3xTF32 sum from zero, the chains
    added in order."""
    steps = qb.shape[-1] // 8
    parts = []
    for c in range(sacc):
        cols = torch.cat([torch.arange(8 * kk, 8 * kk + 8) for kk in range(c, steps, sacc)])
        parts.append(mm3(qb[..., cols], kt[..., cols].transpose(-1, -2)))
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _tf32x3_forward_emulation(q, k, v, *, causal, window):
    """``flash_fwd_tf32x3_kernel`` (f32, dh up to 256) on the CPU. Returns
    (o [B, S, Hq, dh], lse [B, Hq, S])."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    width = min(w for w in FWD_TILE if w >= -(-dh // 8) * 8)
    mt, bn, sacc = FWD_TILE[width]
    rows, group, nk = 64 * mt, 16 * mt, bn // 2
    qh = F.pad(q.float() * dh**-0.5, (0, width - dh)).permute(0, 2, 1, 3)  # q·scale in f32, [B, Hq, S, DH]
    kh, vh = (F.pad(x.float(), (0, width - dh)).repeat_interleave(g, dim=2).permute(0, 2, 1, 3) for x in (k, v))
    o = torch.zeros((b, hq, s, width))
    lse = torch.full((b, hq, s), fa.NEG_INF)
    perm = permuted(nk)
    for q0 in range(0, s, rows):
        q_last = min(q0 + rows, s) - 1
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(t, q_last + 1) if causal else t
        for r0 in range(q0, q0 + rows, group):  # the block's four row groups
            if r0 >= s:
                continue
            r_end = r0 + group - 1
            qpos = torch.arange(r0, r0 + group)
            qb = _rows(qh, r0, group)
            halves = []
            for ks in range(2):  # the two warps of the row group
                m = torch.full((b, hq, group), fa.NEG_INF)  # log2 units
                lsum = torch.zeros((b, hq, group))
                acc = torch.zeros((b, hq, group, width))
                for t0 in range((lo // bn) * bn, hi, bn):
                    kw = t0 + ks * nk
                    if kw >= t or (causal and kw > min(r_end, s - 1)) or (window > 0 and kw + nk - 1 <= r0 - window):
                        continue  # no pair of the warp is kept
                    kpos = torch.arange(kw, kw + nk)
                    keep = kpos[None, :] < t
                    if causal:
                        keep = keep & (kpos[None, :] <= qpos[:, None])
                    if window > 0:
                        keep = keep & (kpos[None, :] > qpos[:, None] - window)
                    kt, vt = _rows(kh, kw, nk), _rows(vh, kw, nk)
                    sc = torch.where(keep, _s_chains(qb, kt, sacc), -torch.inf)
                    m_new = torch.maximum(m, sc.amax(-1) * LOG2E)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(sc * LOG2E - m_new[..., None])
                    lsum = lsum * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + mm3(p[..., perm], vt[..., perm, :])
                    m = m_new
                halves.append((m, lsum, acc))
            (m0, l0, a0), (m1, l1, a1) = halves
            mm = torch.maximum(m0, m1)
            c0, c1 = torch.exp2(m0 - mm), torch.exp2(m1 - mm)
            lsum = l0 * c0 + l1 * c1
            n = min(group, s - r0)
            out = (a0 * c0[..., None] + a1 * c1[..., None]) / torch.clamp(lsum, min=1e-30)[..., None]
            o[:, :, r0:r0 + n] = out[:, :, :n]
            lse[:, :, r0:r0 + n] = torch.where(lsum > 0, (mm + torch.log2(lsum)) * LN2, fa.NEG_INF)[..., :n]
    return o[..., :dh].permute(0, 2, 1, 3).contiguous(), lse


def _case(b, s, t, hq, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh)))


def _attn_close(got, want):
    """``chip_smoke.ATTN_TOL[4]``: elementwise rtol/atol and a limit on the
    relative error of the whole output."""
    rtol, atol, rel = _smoke().ATTN_TOL[4]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    assert torch.linalg.vector_norm(got - want) <= rel * torch.linalg.vector_norm(want)


# b, s, t, hq, hkv, dh, causal, window
FWD = [
    (2, 77, 77, 4, 2, 32, True, 0),  # ragged S (DH 32), GQA 2
    (2, 50, 50, 4, 4, 64, False, 0),  # not causal (DH 64: two m16 tiles a warp)
    (1, 90, 90, 4, 2, 64, True, 7),  # a window below the tile
    (1, 40, 100, 4, 2, 32, True, 0),  # S < T (query positions left-aligned)
    (1, 90, 30, 4, 2, 32, False, 8),  # S > T: rows 37.. keep no key
    (1, 70, 70, 8, 2, 128, True, 0),  # a GQA group of 4 (DH 128)
    (1, 70, 100, 2, 2, 36, True, 24),  # dh 36, padded to 40 (DH 64), S < T, a window
    (1, 130, 130, 2, 1, 256, True, 0),  # DH 256: 16-key tiles, S in four chains
]


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", FWD)
def test_tf32x3_forward_within_attn_tol(b, s, t, hq, hkv, dh, causal, window):
    """The 3xTF32 forward's blocks, row groups, key halves, tiles, hi/lo
    products, permuted key order, per-tile sums and online softmax against
    the plain version within ``ATTN_TOL[4]``, its lse within ``LSE_TOL[4]``;
    rows that keep no key give 0 and NEG_INF."""
    q, k, v = _case(b, s, t, hq, hkv, dh, s + dh)
    got, lse = _tf32x3_forward_emulation(q, k, v, causal=causal, window=window)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    _attn_close(got, want)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=_smoke().LSE_TOL[4])
    if s > t and not causal:
        assert torch.all(got[:, t + window - 1:] == 0) and torch.all(lse[:, :, t + window - 1:] == fa.NEG_INF)


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", [FWD[2], FWD[5], FWD[6]])
def test_tf32x3_forward_matches_pallas(b, s, t, hq, hkv, dh, causal, window):
    """The emulation against the reference's Pallas kernel in interpret mode
    (32-row blocks) within ``ATTN_TOL[4]``: a window below the tile, a GQA
    group of 4, dh 36 with S < T. (Every row keeps a key here: for a row
    that keeps none the reference returns a mean of V and the port 0,
    ROADMAP.md §3.)"""
    q, k, v = _case(b, s, t, hq, hkv, dh, s + dh + 1)
    got, _ = _tf32x3_forward_emulation(q, k, v, causal=causal, window=window)
    want = flash_attention_pallas(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=causal, window=window,
                                  bq=32, bk=32, interpret=True)
    _attn_close(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("where", ["q", "v"])
def test_tf32x3_forward_keeps_nan(where):
    """The GPU's canonical NaN 0x7FFFFFFF (whose hi rounds to -0; the split
    keeps it NaN in lo = x - hi) in q or in v reaches the emulated output
    exactly where it reaches the plain version's: a q element its row, a v
    element its column in every row of the query heads reading that KV
    head. Every pair is kept (not causal, no window), so every tile is
    computed and the NaN sets do not depend on tiling. The rest within
    ``ATTN_TOL[4]``."""
    b, s, hq, hkv, dh = 2, 50, 4, 2, 36
    q, k, v = _case(b, s, s, hq, hkv, dh, 12)
    (q if where == "q" else v)[1, 37, 1, 5] = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    got, _ = _tf32x3_forward_emulation(q, k, v, causal=False, window=0)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    nan = torch.isnan(want)
    assert nan.any() and torch.equal(torch.isnan(got), nan)
    if where == "q":
        assert torch.isnan(got[1, 37, 1]).all() and nan.sum() == dh
    else:
        assert torch.isnan(got[1, :, 2:, 5]).all() and nan.sum() == s * 2
    torch.testing.assert_close(got[~nan], want[~nan], rtol=1e-4, atol=1e-4)
