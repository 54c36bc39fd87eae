"""The attention backward's designs past dh 128 and its f32 design, emulated
on the CPU.

``csrc/flash_attention_bwd.cu`` cannot run here, so its decompositions are
written out in plain torch and held against ``flash_attention_backward_plain``
within ``chip_smoke.BWD_TOL`` and against ``jax.vjp`` of the reference's
chunked online softmax (``repro.models.attention``):

* the 3xTF32 pair (f32, dh up to 256): blocks of 64 or 128 stationary
  rows, key (query) tiles of the compiled width's size, every product as
  three TF32 products a k8 step (each operand split into hi = tf32(x),
  ``torch_tf32.tf32`` being ``cvt.rna.tf32.f32``'s rounding, and lo = x - hi
  read by the tensor core as TF32, ``torch_tf32.tf32_read``)
  summed in f32, the accumulating products contracting in the permuted key
  order of the kernels' fragments and adding each tile's products to their
  sums by f32 adds, dQ in two key halves summed at the end;
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
from torch_tf32 import mm3, permuted, tf32, tf32_read

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


def _tf32x3_emulation(q, k, v, o, do, lse, *, causal, window):
    """``bwd_dq_tf32x3_kernel`` and ``bwd_dkdv_tf32x3_kernel`` (f32, dh up
    to 256): dh padded to a multiple of 8, then zero to the compiled width
    DH. dQ: a block per 64·MT query rows and head (MT m16 tiles a warp),
    K/V tiles of BN keys over the band, each in two halves of BN/2 keys
    (two warps a row group): S
    and dP over DH, P = exp2(S·scale·log2 e - lse·log2 e) where kept, dS =
    P ∘ (dP - D), the half's dQ += dS·K in the permuted key order; the two
    halves summed at the end, then scaled. dK/dV: a block per 64·MT keys
    and KV head, Q/dO tiles of BQ queries over the g heads of the group
    (their lse and D with them): Sᵀ = K·Qᵀ and P (role 0), dPᵀ = V·dOᵀ and
    dS (role 1), dV += Pᵀ·dO and dK += dSᵀ·Q in the permuted query order."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    plan = fa.backward_plan(dh, 4)
    assert plan["route"] == "tf32x3"
    width = plan["width"]
    mt, bn, _, bq, _ = fa._BWD_TF32[width]
    rows, nk = 64 * mt, bn // 2
    scale = dh**-0.5
    c = scale * LOG2E
    qp, kp, vp, dop = (F.pad(x.float(), (0, width - dh)) for x in (q, k, v, do))
    delta = (do.float() * o.float()).sum(-1)  # [B, S, Hq]
    lse2 = lse.float() * LOG2E  # [B, Hq, S]
    dq = torch.zeros((b, s, hq, width))
    dk, dv = torch.zeros((b, t, hkv, width)), torch.zeros((b, t, hkv, width))
    for h in range(hq):
        hk = h // g
        for q0 in range(0, s, rows):
            qpos = torch.arange(q0, q0 + rows)
            qb, dob = _rows(qp[:, :, h], q0, rows), _rows(dop[:, :, h], q0, rows)
            l2 = _rows(lse2[:, h, :, None], q0, rows)[..., 0]
            dd = _rows(delta[:, :, h, None], q0, rows)[..., 0]
            q_last = min(q0 + rows, s) - 1
            lo = max(0, q0 - window + 1) if window > 0 else 0
            hi = min(t, q_last + 1) if causal else t
            halves = [torch.zeros((b, rows, width)) for _ in range(2)]
            for t0 in range((lo // bn) * bn, hi, bn):
                for ks in range(2):
                    kw = t0 + ks * nk
                    kt, vt = _rows(kp[:, :, hk], kw, nk), _rows(vp[:, :, hk], kw, nk)
                    keep = _keep(qpos, torch.arange(kw, kw + nk), s, t, causal, window)
                    sp = mm3(qb, kt.transpose(1, 2))
                    dp = mm3(dob, vt.transpose(1, 2))
                    p = torch.where(keep, torch.exp2(sp * c - l2[..., None]), 0.0)
                    ds = p * (dp - dd[..., None])
                    perm = permuted(nk)
                    halves[ks] = halves[ks] + mm3(ds[..., perm], kt[:, perm])
            n = min(rows, s - q0)
            dq[:, q0:q0 + n, h] = ((halves[0] + halves[1]) * scale)[:, :n]
    perm = permuted(bq)
    for hk in range(hkv):
        for k0 in range(0, t, rows):
            kpos = torch.arange(k0, k0 + rows)
            kb, vb = _rows(kp[:, :, hk], k0, rows), _rows(vp[:, :, hk], k0, rows)
            k_last = min(k0 + rows, t) - 1
            lo = k0 if causal else 0
            hi = min(s, k_last + window) if window > 0 else s
            ak, av = torch.zeros((b, rows, width)), torch.zeros((b, rows, width))
            for h, q0 in [(h, q0) for h in range(hk * g, hk * g + g) for q0 in range((lo // bq) * bq, hi, bq)]:
                qt, dot = _rows(qp[:, :, h], q0, bq), _rows(dop[:, :, h], q0, bq)
                l2 = _rows(lse2[:, h, :, None], q0, bq)[..., 0]
                dd = _rows(delta[:, :, h, None], q0, bq)[..., 0]
                keep = _keep(torch.arange(q0, q0 + bq), kpos, s, t, causal, window).T
                st = mm3(kb, qt.transpose(1, 2))
                pt = torch.where(keep, torch.exp2(st * c - l2[:, None, :]), 0.0)
                dpt = mm3(vb, dot.transpose(1, 2))
                dst = pt * (dpt - dd[:, None, :])
                av = av + mm3(pt[..., perm], dot[:, perm])
                ak = ak + mm3(dst[..., perm], qt[:, perm])
            n = min(rows, t - k0)
            dk[:, k0:k0 + n, hk] = (ak * scale)[:, :n]
            dv[:, k0:k0 + n, hk] = av[:, :n]
    return tuple(x[..., :dh].contiguous() for x in (dq, dk, dv))


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
TF32X3 = [
    (2, 77, 77, 4, 2, 16, True, 0),  # ragged S, dh 16 (DH 32)
    (2, 50, 50, 4, 4, 16, False, 0),  # not causal
    (1, 90, 90, 4, 2, 16, True, 7),  # a window below the tile
    (1, 40, 40, 8, 1, 16, True, 0),  # a GQA group of 8 on one KV head
    (1, 30, 60, 4, 2, 16, True, 0),  # S < T
    (1, 90, 30, 4, 2, 16, False, 8),  # S > T: rows 37.. keep no key
    (1, 70, 100, 2, 2, 36, True, 24),  # dh 36, padded to 40 (DH 64), S < T, a window
    (1, 130, 130, 2, 1, 64, True, 0),  # DH 64, GQA 2, three query blocks
    (1, 100, 100, 4, 2, 128, True, 30),  # DH 128
    (1, 130, 130, 2, 1, 200, True, 0),  # DH 256: 16-key and 16-query tiles
]
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


def test_tf32_rounds_to_nearest_ties_away():
    """``tf32`` (the kernels' ``cvt.rna.tf32.f32``) on hand-picked f32
    values: exact TF32 values stay; half of the last kept bit rounds away
    from zero (ties to even would keep 1.0); just below it rounds down; a
    carry into the exponent; negatives mirror; subnormals round on their
    bits; ±0 and ±inf stay. Every result has its low 13 bits clear, and hi
    plus lo = x - hi as the tensor core reads it leaves less than 2^-21 of
    |x|. A NaN's hi need not be NaN (the GPU's canonical 0x7FFFFFFF carries
    into the sign: -0; 0x7F800001 loses its mantissa: inf), but its lo is
    NaN whatever hi is, so every product of a NaN operand is NaN."""
    def f(bits):
        return torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)

    cases = [
        (1.0, 1.0),
        (1 + 2**-11, 1 + 2**-10),  # a tie: away from zero
        (1 + 2**-11 - 2**-23, 1.0),  # just below the tie
        (1 + 3 * 2**-11, 1 + 2**-9),  # a tie above an odd last bit
        (2 - 2**-11, 2.0),  # the carry reaches the exponent
        (-(1 + 2**-11), -(1 + 2**-10)),
        (-(1 + 2**-12), -1.0),
        (3.0e38, 3.0e38),  # bits 0x7F61B1E6: the dropped 0x11E6 rounds up to 0x7F61C000
        (0.0, 0.0),
        (float("inf"), float("inf")),
        (float("-inf"), float("-inf")),
    ]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    want[7] = f(0x7F61C000)
    assert torch.equal(tf32(x), want)
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    assert torch.equal(tf32(torch.tensor([-0.0])).view(torch.int32), torch.tensor([-0.0]).view(torch.int32))
    nans = torch.cat([f(b) for b in (0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001, 0xFF800001, 0x7FFFF000)])
    assert torch.equal(tf32(nans).view(torch.int32), torch.tensor(
        [0x7FC00000, 0x80000000 - 2**32, 0, 0x7F800000, 0xFF800000 - 2**32, 0x80000000 - 2**32], dtype=torch.int32))
    assert torch.isnan(tf32_read(nans - tf32(nans))).all()
    assert torch.isnan(tf32_read(f(0x7FFFFFFF))).all()
    # subnormals: 2^-149 (bits 1) rounds to 0; bits 0x1000 (a tie) to 0x2000; 0x2fff to 0x2000
    sub = torch.cat([f(1), f(0x1000), f(0x2FFF), f(0x80001000)])
    assert torch.equal(tf32(sub).view(torch.int32), torch.tensor([0, 0x2000, 0x2000, 0x80002000 - 2**32],
                                                                  dtype=torch.int32))
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32)) * 1e3
    hi = tf32(r)
    lo = tf32_read(r - hi)
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi + lo - r).abs() < 2.0**-21 * r.abs()).all()


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", TF32X3)
def test_tf32x3_decomposition_within_bwd_tol(b, s, t, hq, hkv, dh, causal, window):
    """The 3xTF32 pair's blocks, key halves, tiles, permuted contraction
    order, hi/lo splits and f32 sums against the plain backward within
    ``BWD_TOL[4]``; rows that keep no key get dq = 0."""
    q, k, v, o, do, lse = _case(b, s, t, hq, hkv, dh, causal, window, torch.float32, dh + s + 2)
    got = _tf32x3_emulation(q, k, v, o, do, lse, causal=causal, window=window)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, lse, causal=causal, window=window)
    assert max(_rel(got, want)) <= _bwd_tol()[4]
    if s > t and not causal:
        assert torch.all(got[0][:, t + window - 1:] == 0)


@pytest.mark.parametrize("where", ["q", "do"])
def test_tf32x3_decomposition_keeps_nan(where):
    """A NaN in q or in dO reaches the 3xTF32 decomposition's gradients
    exactly where it reaches the plain backward's, and nowhere else: every
    pair is kept (not causal, no window), so every tile is computed and the
    NaN sets do not depend on tiling. A NaN q element makes its row's lse,
    D, P and dS NaN: its dq row and all dk, dv of its KV head; a NaN dO
    element makes D, dP and dS of its row NaN: its dq row, all dk of its KV
    head and one column of dv. The rest within ``BWD_TOL[4]``."""
    b, s, hq, hkv, dh = 2, 50, 4, 2, 36
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   for shape in ((b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh), (b, s, hq, dh)))
    # the GPU's canonical NaN (what a diverging step's arithmetic writes), whose bits carry into the sign
    # when hi is rounded
    (q if where == "q" else do)[1, 37, 3, 5] = torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(torch.float32)
    o, lse = fa.flash_attention_plain(q, k, v, causal=False, return_lse=True)
    got = _tf32x3_emulation(q, k, v, o, do, lse, causal=False, window=0)
    want = fa.flash_attention_backward_plain(q, k, v, o, do, lse, causal=False)
    for g, w in zip(got, want):
        nan = torch.isnan(w)
        assert nan.any() and torch.equal(torch.isnan(g), nan)
        assert _rel([g[~nan]], [w[~nan]])[0] <= _bwd_tol()[4]
    assert torch.isnan(got[0][1, 37, 3]).all() and not torch.isnan(got[0][1, 36]).any()
    assert torch.isnan(got[1][1, :, 1]).all() and not torch.isnan(got[1][:, :, 0]).any()
    assert torch.isnan(got[2][1, :, 1]).all() if where == "q" else torch.isnan(got[2][1, :, 1, 5]).all()


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", [TF32X3[3], TF32X3[6], TF32X3[9]])
def test_tf32x3_decomposition_matches_jax_vjp(b, s, t, hq, hkv, dh, causal, window):
    """The 3xTF32 decomposition against ``jax.vjp`` of the reference's
    chunked softmax in f32 within ``BWD_TOL[4]``: a GQA group of 8 on one
    KV head, dh 36 (DH 64) with S < T and a window, dh 200 (DH 256). (Every
    row keeps a key here: for a row that keeps none the reference returns a
    mean of V and the port 0, ROADMAP.md §3.)"""
    q, k, v, o, do, lse = _case(b, s, t, hq, hkv, dh, causal, window, torch.float32, dh + s + 3)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash_attention(q_, k_, v_, causal=causal, window=window,
                                                         q_chunk=32, kv_chunk=32),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    want = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(do.numpy()))]
    got = _tf32x3_emulation(q, k, v, o, do, lse, causal=causal, window=window)
    assert max(_rel(got, want)) <= _bwd_tol()[4]


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
    handed to the kernels (dh padded to a multiple of 8 on every route),
    column slices covering dh, every block's dynamic shared memory within
    the H100's 232,448 bytes, and the wgmma consumers' registers for
    accumulators and operands within the 240 setmaxnreg gives; the 3xTF32
    pair one slice of its compiled width (32, 64, 128, 256) in 256
    threads."""
    for es in (2, 4):
        for dh in range(1, 1025):
            p = fa.backward_plan(dh, es)
            want = ("wgmma" if dh <= 128 else "wgmma_split" if dh <= 512 else "wide") if es == 2 else \
                ("tf32x3" if dh <= 256 else "wide")
            assert p["route"] == want, (es, dh, p)
            dp = p["dp"]
            assert dp % 8 == 0 and dh <= dp < dh + 8, (es, dh, p)
            assert max(p["dq_smem"], p["dkdv_smem"]) <= fa.SMEM_MAX, (es, dh, p)
            if want in ("wgmma", "wgmma_split"):
                assert p["width"] >= dp and p["dq_slices"] == 1 and p["dkdv_slices"] * p["cols"] == p["width"]
                assert max(p["regs"]) <= 240, (es, dh, p)
                assert p["threads"] == 384
            elif want == "tf32x3":
                assert p["width"] == min(w for w in (32, 64, 128, 256) if w >= dp), (es, dh, p)
                assert p["dq_slices"] == p["dkdv_slices"] == 1 and p["cols"] == p["width"], (es, dh, p)
                assert p["regs"] is None and p["threads"] == 256
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
