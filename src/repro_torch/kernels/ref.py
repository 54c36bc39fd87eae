"""Plain PyTorch versions of the kernels' functions and of the engine merges.

Every scan kernel in this package has its plain version here; the CPU tests
hold these against ``repro.kernels.ref`` and ``chip_smoke.py`` holds each
kernel against them on the card. Attention's plain version (the chunked
online softmax) lives beside its kernel in ``flash_attention.py``;
``flash_attention_ref`` here is the whole-row oracle.

Tie rule everywhere: (score descending, index ascending) — ``lax.top_k``'s
smallest-index-first order. ``torch.topk`` gives no tie order, so ranks come
from stable sorts (``stable_topk``).
"""
from __future__ import annotations

import torch

NEG_INF = float(-3.4e38)


def stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim of a 2-D tensor under (score desc, index asc).

    ``torch.topk`` supplies the k+1 largest values, which are exact whatever
    its tie order; a row whose k+1 largest values are pairwise distinct (above
    the masked-score band) then has exactly one top-k, and ``topk``'s indices
    are it. Rows with a tie there are re-ranked by a full stable sort. Ties
    inside the masked band (``<= NEG_INF / 2``) are left to ``topk``: their
    ids become -1 in every caller. Returns (values [r, k], int64 idx [r, k]).
    """
    n = scores.shape[-1]
    if n <= k + 1:
        top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
        return top[:, :k], idx[:, :k]
    top, idx = torch.topk(scores, k + 1, dim=-1, largest=True, sorted=True)
    tied = ((top[:, 1:] == top[:, :-1]) & (top[:, 1:] > NEG_INF / 2)).any(dim=1)
    top, idx = top[:, :k].clone(), idx[:, :k].clone()
    rows = torch.nonzero(tied).flatten()
    if rows.numel():
        s, i = torch.sort(scores[rows], dim=-1, descending=True, stable=True)
        top[rows] = s[:, :k]
        idx[rows] = i[:, :k]
    return top, idx


def normalize_merge_sentinels(
    scores: torch.Tensor, idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonical absent-result encoding shared by every merge path.

    Merge inputs carry two sentinel flavors — ``-inf`` (allocation padding)
    and the kernels' finite ``NEG_INF`` with idx -1. This maps every absent
    entry to exactly (-inf, -1): an entry is absent iff its idx is negative or
    its score is non-finite.
    """
    scores = torch.where(idx < 0, torch.full_like(scores, -float("inf")), scores)
    idx = torch.where(torch.isfinite(scores), idx, torch.full_like(idx, -1))
    return scores, idx


def segmented_merge_topk_ref(
    flat_s: torch.Tensor,  # f32 [C, kk] — candidate rows, any per-segment count
    flat_i: torch.Tensor,  # int [C, kk] — candidate ids (-1 = absent)
    seg_of: torch.Tensor,  # i32 [C] — owning segment per row, ASCENDING; >= n_segments = drop
    n_segments: int,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged per-segment top-k: CSR-style rows -> [n_segments, k].

    One stable sort by (segment, -score) ranks every candidate inside its
    segment (two stable sorts: by -score, then by segment); rank < k
    survives. Stability keeps the original candidate order among exactly
    equal scores, which is ``lax.top_k``'s smallest-index-first rule. Rows
    whose ``seg_of`` is ``n_segments`` or above are padding and are dropped.
    """
    C, kk = flat_s.shape
    dev = flat_s.device
    if n_segments == 0:
        return (
            torch.zeros((0, k), dtype=torch.float32, device=dev),
            torch.zeros((0, k), dtype=flat_i.dtype, device=dev),
        )
    n = C * kk
    s = flat_s.reshape(n)
    i = flat_i.reshape(n)
    seg = torch.repeat_interleave(seg_of.to(torch.int64), kk)
    by_score = torch.sort(-s, stable=True).indices
    order = by_score[torch.sort(seg[by_score], stable=True).indices]
    s_s, i_s, seg_s = s[order], i[order], seg[order]
    starts = torch.searchsorted(seg_s, torch.arange(n_segments, device=dev))
    pos = torch.arange(n, device=dev) - starts[seg_s.clamp(0, n_segments - 1)]
    keep = (seg_s < n_segments) & (pos < k)
    out_s = torch.full((n_segments, k), -float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((n_segments, k), -1, dtype=flat_i.dtype, device=dev)
    out_s[seg_s[keep], pos[keep]] = s_s[keep].to(torch.float32)
    out_i[seg_s[keep], pos[keep]] = i_s[keep]
    return normalize_merge_sentinels(out_s, out_i)


def pairwise_scores_ref(q: torch.Tensor, v: torch.Tensor, metric: str = "ip") -> torch.Tensor:
    """Similarity scores, best = max. q [..., nq, d], v [..., nv, d] -> f32
    [..., nq, nv] (leading dims batch, e.g. the W work units of a bucket).

    ip: q·v          l2: 2·q·v − ‖q‖² − ‖v‖²  (= −‖q − v‖², so max = nearest)
    """
    q = q.to(torch.float32)
    v = v.to(torch.float32)
    ip = q @ v.transpose(-1, -2)
    if metric == "ip":
        return ip
    if metric == "l2":
        qn = (q * q).sum(dim=-1, keepdim=True)  # [..., nq, 1]
        vn = (v * v).sum(dim=-1)[..., None, :]  # [..., 1, nv]
        return 2.0 * ip - qn - vn
    raise ValueError(metric)


_LOW29, _MID = 0x1FFFFFFF, 0x10000000  # an fp64 value on an fp32 midpoint: its low 29 mantissa bits
_TINY = 2.0**-125  # below it fp32 rounds at a coarser place (subnormals): always the exact path


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """CUDA's ``fmaf`` on the CPU, bit for bit: ``a·b + c`` rounded once to
    fp32 (round to nearest even). a, b, c: fp32 values (a and b may come
    widened to fp64); returns fp32.

    The product of two fp32 values is exact in fp64 (24 + 24 bits < 53).
    Rounding ``p + c`` to fp64 and then to fp32 is not: the first rounding
    can land on a midpoint between two fp32 values that ``p + c`` itself is
    not on, and the second then breaks the tie the wrong way (a = b = 1 +
    2⁻¹², c = 2⁻⁸⁰). That is the only way the two roundings go wrong (any
    other fp32 midpoint between the sum and its fp64 rounding would be a
    nearer fp64 value), so where the fp64 sum sits on a midpoint (or is
    tiny) it is rounded to odd instead: TwoSum gives its rounding error, and
    where that is not 0 and the sum's last bit is even, the sum moves one
    fp64 ulp toward the error. A value rounded to odd with at least 2·24 + 2
    bits rounds to fp32 as the exact sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bits = s.view(torch.int64)
    at_mid = ((bits & _LOW29) == _MID) | (s.abs() < _TINY)
    if bool(at_mid.any()):
        z = s - p
        err = (p - (s - z)) + (c - z)  # p + c - s exactly (TwoSum)
        nudge = at_mid & (err != 0) & ((bits & 1) == 0)
        s = torch.where(nudge, torch.nextafter(s, torch.full_like(s, float("inf")).copysign_(err)), s)
    return s.float()


def fmaf_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``acc = fmaf(a[..., c], b[..., c], acc)`` from ``acc = 0.f`` over c = 0
    … D-1 (a and b broadcast against each other), the order of the f32 scan
    kernels' sums; fp32 [...]."""
    a64, b64 = a.to(torch.float32).double(), b.to(torch.float32).double()
    shape = torch.broadcast_shapes(a64.shape[:-1], b64.shape[:-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device)
    for c in range(a64.shape[-1]):
        acc = fmaf(a64[..., c], b64[..., c], acc)
    return acc


def kernel_order_scores(q: torch.Tensor, v: torch.Tensor, metric: str = "ip") -> torch.Tensor:
    """``pairwise_scores_ref`` summed in the f32 scan kernels' order
    (``csrc/fused_knn.cu``), so that on the same inputs the kernels match it
    bit for bit: q·v is one ``fmaf`` chain per (query, row) from 0.f over
    c = 0 … D-1, ‖q‖² and ‖v‖² are chains of the same kind, and l2 is
    ``(2·ip − ‖q‖²) − ‖v‖²`` in fp32; bf16 inputs are widened to fp32 first.
    q [..., nq, d], v [..., nv, d] -> f32 [..., nq, nv]. A loop over d in
    fp64: the kernels' plain version uses it, the exhaustive oracle and
    k-means keep the matmul of ``pairwise_scores_ref``."""
    if metric not in ("ip", "l2"):
        raise ValueError(metric)
    ip = fmaf_chain(q[..., :, None, :], v[..., None, :, :])
    if metric == "ip":
        return ip
    qn = fmaf_chain(q, q)[..., :, None]
    vn = fmaf_chain(v, v)[..., None, :]
    return (2.0 * ip - qn) - vn


def masked_topk_ref(
    q: torch.Tensor,
    v: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    metric: str = "ip",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k masked similarity search.

    q [..., nq, d], v [..., nv, d], valid bool [..., nv] (the pushdown bitmap
    of Section 4.2; leading dims batch, as the W work units of a bucket).
    Returns (scores f32 [..., nq, k] best-first, idx int32 [..., nq, k]);
    masked-out or absent entries have score ``NEG_INF`` and idx -1.
    """
    return masked_topk_of_scores(pairwise_scores_ref(q, v, metric), valid, k)


def masked_topk_of_scores(
    scores: torch.Tensor, valid: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask scores [..., nq, nv] by valid [..., nv] and take the top-k under
    (score desc, index asc); absent slots are (NEG_INF, -1)."""
    scores = torch.where(valid[..., None, :], scores, torch.full_like(scores, NEG_INF))
    top, idx = stable_topk(scores.reshape(-1, scores.shape[-1]), k)
    idx = torch.where(top <= NEG_INF / 2, torch.full_like(idx, -1), idx)
    out_shape = scores.shape[:-1] + (k,)
    return top.reshape(out_shape), idx.to(torch.int32).reshape(out_shape)


def dead_slots_absent(
    s: torch.Tensor, i: torch.Tensor, n_live: torch.Tensor | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scan outputs [W, TQ, k] with ``(NEG_INF, -1)`` on every slot s of unit
    w with s >= ``n_live[w]`` (the slots that hold no query); ``None``:
    unchanged."""
    if n_live is None:
        return s, i
    dead = torch.arange(s.shape[1], device=s.device)[None, :] >= n_live.to(s.device)[:, None]
    return s.masked_fill(dead[..., None], NEG_INF), i.masked_fill(dead[..., None], -1)


def adc_scores_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC scores: luts f32 [..., nq, M, 256], codes uint8/int [..., nv, M] ->
    f32 [..., nq, nv], ``score[q, v] = Σ_m lut[q, m, code[v, m]]``.

    The M lookups are summed in fp32 in the order m = 0, 1, …, M-1, one
    rounding per add, as the CUDA kernels sum them; so on the same inputs
    the kernels match this function bit for bit.
    """
    lead = luts.shape[:-3]
    nq, m = luts.shape[-3], luts.shape[-2]
    nv = codes.shape[-2]
    c = codes.to(torch.int64)
    scores = torch.zeros(lead + (nq, nv), dtype=torch.float32, device=luts.device)
    for j in range(m):
        idx = c[..., None, :, j].expand(lead + (nq, nv))
        scores = scores + torch.gather(luts[..., j, :].to(torch.float32), -1, idx)
    return scores


def adc_topk_ref(
    luts: torch.Tensor,  # f32 [..., nq, M, 256] — per-query ADC lookup tables
    codes: torch.Tensor,  # uint8/int [..., nv, M]
    valid: torch.Tensor,  # bool [..., nv]
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """ADC scan + top-k (the compressed counterpart of ``masked_topk_ref``).

    score[q, v] = Σ_m lut[q, m, code[v, m]], summed as ``adc_scores_ref``
    says — higher is better (``adc_tables`` negates l2). Returns (scores f32
    [..., nq, k] best-first under (score desc, index asc), idx int32
    [..., nq, k]); masked-out or absent entries are (NEG_INF, -1).
    """
    return masked_topk_of_scores(adc_scores_ref(luts, codes), valid, int(k))


def workunit_pq_topk_ref(
    luts: torch.Tensor,  # f32 [W, TQ, M, 256]
    codes: torch.Tensor,  # uint8/int [W, TV, M]
    valid: torch.Tensor,  # bool [W, TV]
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched work-unit ADC: ``adc_topk_ref`` over the unit dim."""
    return adc_topk_ref(luts, codes, valid, k)


def workunit_pq_topk_resident_ref(
    table: torch.Tensor,  # f32 [U, M, 256] — resident ADC tables
    lut_idx: torch.Tensor,  # int [W, TQ] — row of ``table`` per unit slot (-1: no query)
    codes: torch.Tensor,  # uint8/int [W, TV, M]
    valid: torch.Tensor,  # bool [W, TV]
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``workunit_pq_topk_ref`` over ``table[lut_idx]``, bit for bit, without
    expanding the table: each subspace's lookup reads (LUT row, code)
    straight from ``table``, summed in the same order. A slot of index -1
    holds no query: it is ``(NEG_INF, -1)`` and reads nothing. Any other
    index outside ``[0, U)`` raises ``IndexError`` (no wrap-around)."""
    li = lut_idx.to(torch.int64)
    U = table.shape[0]
    bad = (li < -1) | (li >= U)
    if bool(bad.any()):
        raise IndexError(f"lut_idx {int(li[bad][0])} outside [0, {U}) (-1 marks a slot with no query)")
    W, TQ = li.shape
    k = int(k)
    out_s = torch.full((W, TQ, k), NEG_INF, dtype=torch.float32, device=table.device)
    out_i = torch.full((W, TQ, k), -1, dtype=torch.int32, device=table.device)
    w, t = torch.nonzero(li >= 0, as_tuple=True)
    if w.numel() == 0:
        return out_s, out_i
    rows = li[w, t][:, None]  # [n, 1]
    scores = torch.zeros((w.numel(), codes.shape[1]), dtype=torch.float32, device=table.device)
    for j in range(table.shape[1]):
        scores = scores + table[:, j, :].to(torch.float32)[rows, codes[:, :, j].to(torch.int64)[w]]
    s, i = masked_topk_of_scores(scores[:, None, :], valid[w], k)
    out_s[w, t] = s[:, 0]
    out_i[w, t] = i[:, 0]
    return out_s, out_i


def flash_attention_ref(
    q: torch.Tensor,  # [B, Hq, S, dh]
    k: torch.Tensor,  # [B, Hkv, T, dh]
    v: torch.Tensor,  # [B, Hkv, T, dh]
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Reference attention over whole rows (GQA: Hq % Hkv == 0), in f32.

    Query positions are right-aligned (``qpos = i + T - S``, the decode
    convention); the kernel and its plain version put them at ``i``, which
    agrees wherever S = T. ``window`` (if set) = W: position i attends to
    (i - W, i].
    """
    b, hq, s, dh = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / (dh**0.5)
    qf = q.to(torch.float32) * scale
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    t = kf.shape[2]
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)
