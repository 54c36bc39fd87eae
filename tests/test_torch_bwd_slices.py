"""The attention backward's designs past dh 128, emulated on the CPU.

``csrc/flash_attention_bwd.cu`` cannot run here, so its decompositions are
written out in plain torch and held against ``flash_attention_backward_plain``
within ``chip_smoke.BWD_TOL`` and, at one wide shape, against ``jax.vjp`` of
the reference's chunked online softmax (``repro.models.attention``):

* the split wgmma pair (bf16, dh 129..512): blocks of 64 stationary rows,
  S and dP over the padded width once a tile, P and dS rounded to bf16
  before their products, dK/dV in column slices of ``cols``;
* the wide CUDA-core pair (f32 past 256, bf16 past 512): blocks of 32
  stationary rows and one slice of at most 512 columns, S and dP summed over
  dh 32 columns at a time once a 64-row tile for every column of the slice,
  P and dS in f32.

``backward_plan`` (the wrapper's launch plan, mirrored from the C entry) is
checked for every dh up to 1024 in both types.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models.attention import flash_attention as jflash_attention
from repro_torch.kernels import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634


def _bwd_tol():
    """``chip_smoke.py``'s BWD_TOL: the card's limit on ||got - want|| /
    ||want|| of each gradient, by element size."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.BWD_TOL


def _keep(qpos, kpos, s, t, causal, window):
    """bool [len(qpos), len(kpos)]: key kept for the query row (the kernels'
    ``kept``: inside S and T, causal, inside the window)."""
    m = (qpos[:, None] < s) & (kpos[None, :] < t)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _rows(x, r0, n):
    """Rows r0 .. r0 + n of x [B, L, ...] along dim 1 in f32, zero past L
    (as TMA and the zero-filled copies land them)."""
    out = torch.zeros((x.shape[0], n) + tuple(x.shape[2:]), dtype=torch.float32)
    m = max(0, min(n, x.shape[1] - r0))
    out[:, :m] = x[:, r0:r0 + m].float()
    return out


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split_emulation(q, k, v, o, do, lse, *, causal, window):
    """``bwd_dq_wgmma_split_kernel`` and ``bwd_dkdv_wgmma_split_kernel``:
    dh padded to the compiled width DH with zeros. dQ: a block per 64 query
    rows and head, K/V tiles of BN keys over the band, S and dP over all of
    DH, P = exp2(S·scale·log2 e - lse·log2 e) where kept, dS = P ∘ (dP - D)
    rounded to bf16, dQ += dS·K (both column halves at once here). dK/dV: a
    block per 64 keys, KV head and slice of ``cols`` columns, Q/dO tiles of
    BQ queries over the g heads of the group, Sᵀ and dPᵀ over all of DH in
    each slice, dV += bf16(Pᵀ)·dO and dK += bf16(dSᵀ)·Q on the slice's
    columns. Each output rounded to bf16 once."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    plan = fa.backward_plan(dh, 2)
    width, cols = plan["width"], plan["cols"]
    bn, _, bq, _, _ = fa._BWD_WGMMA[width]
    scale = dh**-0.5
    c = scale * LOG2E
    qp, kp, vp, dop = (F.pad(x.float(), (0, width - dh)) for x in (q, k, v, do))
    delta = (do.float() * o.float()).sum(-1)  # [B, S, Hq]
    lse2 = lse.float() * LOG2E  # [B, Hq, S]
    dq = torch.zeros((b, s, hq, width))
    dk, dv = torch.zeros((b, t, hkv, width)), torch.zeros((b, t, hkv, width))
    for h in range(hq):
        hk = h // g
        for q0 in range(0, s, 64):
            qpos = torch.arange(q0, q0 + 64)
            qb, dob = _rows(qp[:, :, h], q0, 64), _rows(dop[:, :, h], q0, 64)
            l2 = _rows(lse2[:, h, :, None], q0, 64)[..., 0]
            dd = _rows(delta[:, :, h, None], q0, 64)[..., 0]
            q_last = min(q0 + 64, s) - 1
            lo = max(0, q0 - window + 1) if window > 0 else 0
            hi = min(t, q_last + 1) if causal else t
            acc = torch.zeros((b, 64, width))
            for t0 in range((lo // bn) * bn, hi, bn):
                kt, vt = _rows(kp[:, :, hk], t0, bn), _rows(vp[:, :, hk], t0, bn)
                keep = _keep(qpos, torch.arange(t0, t0 + bn), s, t, causal, window)
                p = torch.where(keep, torch.exp2(qb @ kt.transpose(1, 2) * c - l2[..., None]), 0.0)
                ds = _bf16(p * (dob @ vt.transpose(1, 2) - dd[..., None]))
                acc += ds @ kt
            n = min(64, s - q0)
            dq[:, q0:q0 + n, h] = acc[:, :n] * scale
    for hk in range(hkv):
        for k0 in range(0, t, 64):
            kpos = torch.arange(k0, k0 + 64)
            kb, vb = _rows(kp[:, :, hk], k0, 64), _rows(vp[:, :, hk], k0, 64)
            k_last = min(k0 + 64, t) - 1
            lo = k0 if causal else 0
            hi = min(s, k_last + window) if window > 0 else s
            for c0 in range(0, width, cols):
                ak, av = torch.zeros((b, 64, cols)), torch.zeros((b, 64, cols))
                for h in range(hk * g, hk * g + g):
                    for q0 in range((lo // bq) * bq, hi, bq):
                        qpos = torch.arange(q0, q0 + bq)
                        qt, dot = _rows(qp[:, :, h], q0, bq), _rows(dop[:, :, h], q0, bq)
                        l2 = _rows(lse2[:, h, :, None], q0, bq)[..., 0]
                        dd = _rows(delta[:, :, h, None], q0, bq)[..., 0]
                        keep = _keep(qpos, kpos, s, t, causal, window).T
                        pt = torch.where(keep, torch.exp2(kb @ qt.transpose(1, 2) * c - l2[:, None, :]), 0.0)
                        dst = pt * (vb @ dot.transpose(1, 2) - dd[:, None, :])
                        av += _bf16(pt) @ dot[..., c0:c0 + cols]
                        ak += _bf16(dst) @ qt[..., c0:c0 + cols]
                n = min(64, t - k0)
                dk[:, k0:k0 + n, hk, c0:c0 + cols] = ak[:, :n] * scale
                dv[:, k0:k0 + n, hk, c0:c0 + cols] = av[:, :n]
    return tuple(x[..., :dh].to(torch.bfloat16) for x in (dq, dk, dv))


def _wide_emulation(q, k, v, o, do, lse, *, causal, window):
    """``bwd_dq_wide_kernel`` and ``bwd_dkdv_wide_kernel``: dh padded to a
    multiple of 8; a block per 32 stationary rows (queries of a head; keys
    of a KV head) and slice of ``cols`` columns; per 64-row moving tile S
    and dP summed over dh 32 columns at a time, once for every column of
    the slice; P = exp(S·scale - lse) where kept and dS = P ∘ (dP - D) in
    f32; dQ += dS·K, dK += dSᵀ·Q, dV += Pᵀ·dO over the tile's rows. Outputs
    in the inputs' type."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    plan = fa.backward_plan(dh, q.element_size())
    dp, cols, slices = plan["dp"], plan["cols"], plan["dq_slices"]
    assert plan["route"] == "wide" and plan["dkdv_slices"] == slices
    scale = dh**-0.5
    qp, kp, vp, dop = (F.pad(x.float(), (0, dp - dh)) for x in (q, k, v, do))
    delta = (do.float() * o.float()).sum(-1)
    lsef = lse.float()

    def sums(a, x):  # [B, R, dp] · [B, M, dp]ᵀ, 32 columns at a time
        out = torch.zeros((a.shape[0], a.shape[1], x.shape[1]))
        for d0 in range(0, dp, 32):
            out += a[..., d0:d0 + 32] @ x[..., d0:d0 + 32].transpose(1, 2)
        return out

    dq = torch.zeros((b, s, hq, dp))
    dk, dv = torch.zeros((b, t, hkv, dp)), torch.zeros((b, t, hkv, dp))
    for sl in range(slices):
        c0, c1 = sl * cols, min(dp, (sl + 1) * cols)
        for h in range(hq):
            hk = h // g
            for r0 in range(0, s, 32):
                qpos = torch.arange(r0, r0 + 32)
                qb, dob = _rows(qp[:, :, h], r0, 32), _rows(dop[:, :, h], r0, 32)
                ls = _rows(lsef[:, h, :, None], r0, 32)[..., 0]
                dd = _rows(delta[:, :, h, None], r0, 32)[..., 0]
                q_last = min(r0 + 32, s) - 1
                lo = max(0, r0 - window + 1) if window > 0 else 0
                hi = min(t, q_last + 1) if causal else t
                acc = torch.zeros((b, 32, c1 - c0))
                for m0 in range((lo // 64) * 64, hi, 64):
                    kt, vt = _rows(kp[:, :, hk], m0, 64), _rows(vp[:, :, hk], m0, 64)
                    keep = _keep(qpos, torch.arange(m0, m0 + 64), s, t, causal, window)
                    p = torch.where(keep, torch.exp(sums(qb, kt) * scale - ls[..., None]), 0.0)
                    acc += (p * (sums(dob, vt) - dd[..., None])) @ kt[..., c0:c1]
                n = min(32, s - r0)
                dq[:, r0:r0 + n, h, c0:c1] = acc[:, :n] * scale
        for hk in range(hkv):
            for r0 in range(0, t, 32):
                kpos = torch.arange(r0, r0 + 32)
                kb, vb = _rows(kp[:, :, hk], r0, 32), _rows(vp[:, :, hk], r0, 32)
                k_last = min(r0 + 32, t) - 1
                lo = r0 if causal else 0
                hi = min(s, k_last + window) if window > 0 else s
                ak, av = torch.zeros((b, 32, c1 - c0)), torch.zeros((b, 32, c1 - c0))
                for h in range(hk * g, hk * g + g):
                    for m0 in range((lo // 64) * 64, hi, 64):
                        qt, dot = _rows(qp[:, :, h], m0, 64), _rows(dop[:, :, h], m0, 64)
                        ls = _rows(lsef[:, h, :, None], m0, 64)[..., 0]
                        dd = _rows(delta[:, :, h, None], m0, 64)[..., 0]
                        keep = _keep(torch.arange(m0, m0 + 64), kpos, s, t, causal, window).T
                        pt = torch.where(keep, torch.exp(sums(kb, qt) * scale - ls[:, None, :]), 0.0)
                        dst = pt * (sums(vb, dot) - dd[:, None, :])
                        av += pt @ dot[..., c0:c1]
                        ak += dst @ qt[..., c0:c1]
                n = min(32, t - r0)
                dk[:, r0:r0 + n, hk, c0:c1] = ak[:, :n] * scale
                dv[:, r0:r0 + n, hk, c0:c1] = av[:, :n]
    return tuple(x[..., :dh].to(q.dtype) for x in (dq, dk, dv))


def _case(b, s, t, hq, hkv, dh, causal, window, dtype, seed):
    """Inputs from a numpy seed in ``dtype``; o and lse from the plain
    forward on them."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
                   for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh), (b, s, hq, dh)))
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal, window=window, return_lse=True)
    return q, k, v, o, do, lse


def _rel(got, want):
    return [float(torch.linalg.vector_norm(a.float() - w.float()) / torch.linalg.vector_norm(w.float()))
            for a, w in zip(got, want)]


# b, s, t, hq, hkv, dh, causal, window
SPLIT = [
    (1, 130, 130, 4, 2, 136, True, 0),  # DH 256, three query blocks, GQA 2
    (1, 90, 30, 2, 1, 264, False, 8),  # DH 384 in two dK/dV slices; S > T: rows 37.. keep no key
    (2, 70, 100, 2, 2, 320, True, 24),  # S < T, a window
]
WIDE = [
    (1, 130, 130, 4, 2, 264, True, 0, torch.float32),  # one slice of 264 (three 128-column groups)
    (1, 90, 30, 2, 1, 320, False, 8, torch.float32),  # S > T: rows that keep no key
    (1, 70, 100, 2, 1, 520, True, 24, torch.float32),  # two slices of 264, a window
    (1, 64, 64, 4, 2, 520, True, 0, torch.bfloat16),  # bf16 past 512
]


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", SPLIT)
def test_split_wgmma_decomposition_within_bwd_tol(b, s, t, hq, hkv, dh, causal, window):
    """The split wgmma pair's tiles, slices and bf16 roundings against the
    plain backward in bf16 within ``BWD_TOL[2]``; rows that keep no key get
    dq = 0."""
    q, k, v, o, do, lse = _case(b, s, t, hq, hkv, dh, causal, window, torch.bfloat16, dh + s)
    assert fa.backward_plan(dh, 2)["route"] == "wgmma_split"
    got = _split_emulation(q, k, v, o, do, lse, causal=causal, window=window)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, lse, causal=causal, window=window)
    assert max(_rel(got, want)) <= _bwd_tol()[2]
    if s > t and not causal:
        assert torch.all(got[0][:, t + window - 1:] == 0)


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window,dtype", WIDE)
def test_wide_pair_decomposition_within_bwd_tol(b, s, t, hq, hkv, dh, causal, window, dtype):
    """The wide pair's blocks, slices, dh chunks and moving tiles against
    the plain backward within ``BWD_TOL`` of the type (f32: the order of the
    sums)."""
    q, k, v, o, do, lse = _case(b, s, t, hq, hkv, dh, causal, window, dtype, dh + s + 1)
    got = _wide_emulation(q, k, v, o, do, lse, causal=causal, window=window)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, lse, causal=causal, window=window)
    assert max(_rel(got, want)) <= _bwd_tol()[q.element_size()]
    if s > t and not causal:
        assert torch.all(got[0][:, t + window - 1:] == 0)


def test_wide_designs_match_jax_vjp_at_dh_320():
    """At dh 320 (S ≠ T, a window, GQA 2) both decompositions against
    ``jax.vjp`` of the reference's chunked softmax in f32: the wide pair
    within ``BWD_TOL[4]``, the split wgmma pair (its inputs, P and dS in
    bf16) within ``BWD_TOL[2]``."""
    b, s, t, hq, hkv, dh, causal, window = 1, 40, 56, 4, 2, 320, True, 12
    q, k, v, o, do, lse = _case(b, s, t, hq, hkv, dh, causal, window, torch.float32, 7)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash_attention(q_, k_, v_, causal=causal, window=window,
                                                         q_chunk=16, kv_chunk=16),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(do.numpy()))]
    tol = _bwd_tol()
    got = _wide_emulation(q, k, v, o, do, lse, causal=causal, window=window)
    assert max(_rel(got, want)) <= tol[4]
    qb, kb, vb, ob, dob = (x.to(torch.bfloat16) for x in (q, k, v, o, do))
    got = _split_emulation(qb, kb, vb, ob, dob, lse, causal=causal, window=window)
    assert max(_rel(got, want)) <= tol[2]


def test_backward_plan_for_every_width():
    """For every dh 1..1024 in both types: the documented route, the width
    handed to the kernels (dh itself on the tiled route, else padded to a
    multiple of 8), column slices covering dh, every block's dynamic shared
    memory within the H100's 232,448 bytes, and the wgmma consumers'
    registers for accumulators and operands within the 240 setmaxnreg
    gives."""
    for es in (2, 4):
        for dh in range(1, 1025):
            p = fa.backward_plan(dh, es)
            want = ("wgmma" if dh <= 128 else "wgmma_split" if dh <= 512 else "wide") if es == 2 else \
                ("tiled" if dh <= 256 else "wide")
            assert p["route"] == want, (es, dh, p)
            dp = p["dp"]
            assert dp == dh if want == "tiled" else (dp % 8 == 0 and dh <= dp < dh + 8), (es, dh, p)
            assert max(p["dq_smem"], p["dkdv_smem"]) <= fa.SMEM_MAX, (es, dh, p)
            if want in ("wgmma", "wgmma_split"):
                assert p["width"] >= dp and p["dq_slices"] == 1 and p["dkdv_slices"] * p["cols"] == p["width"]
                assert max(p["regs"]) <= 240, (es, dh, p)
                assert p["threads"] == 384
            elif want == "tiled":
                assert p["width"] >= dh and p["dq_slices"] * p["cols"] == p["width"] and p["regs"] is None
            else:
                n, cols = p["dq_slices"], p["cols"]
                assert n == p["dkdv_slices"] and (n - 1) * cols < dp <= n * cols, (es, dh, p)
                assert 256 < cols <= 512 and cols % 8 == 0, (es, dh, p)  # 3 or 4 column groups of 128
                assert p["width"] % 32 == 0 and dp <= p["width"] < dp + 32
                assert p["regs"] is None and p["threads"] == 256
    # the shapes the card measures stage their stationary rows once
    assert fa.backward_plan(512, 4)["stationary"] == (1, 1)
    assert fa.backward_plan(640, 2)["stationary"] == (1, 1)
    assert fa.backward_plan(1024, 4)["stationary"] == (0, 0)
