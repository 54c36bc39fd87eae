"""Forward flash attention: online softmax, causal and sliding-window masks,
grouped-query heads (the prefill hot path of the LM serving path).

``flash_attention`` takes ``q [B, S, Hq, dh]``, ``k``/``v [B, T, Hkv, dh]``
(f32 or bf16, one type) and returns ``[B, S, Hq, dh]`` in q's type. On a
CUDA tensor it launches a kernel of ``csrc/flash_attention.cu`` (or raises),
both on the tensor cores: bf16 inputs ``flash_fwd_wgmma_kernel`` (wgmma
products, K/V tiles through a TMA ring), f32 inputs
``flash_fwd_tf32x3_kernel`` (three TF32 ``mma.sync`` products a k8 step on
hi/lo splits, K/V tiles through a cp.async ring); past ``MAX_HEAD_DIM`` O
in column slices of at most 256 and the logits summed over dh in slices
(``flash_attention_wide``: bf16 up to ``WIDE_WGMMA_MAX`` on the tensor
cores, f32 and wider bf16 on CUDA cores). On a CPU tensor it
runs the plain version, ``flash_attention_plain``. ``launches`` on the
wrapper counts the tiled kernels' launches, ``flash_attention_wide.launches``
the wide ones', and ``calls`` on the plain version its calls.

Training: with grad enabled and an input that requires grad,
``flash_attention`` goes through an autograd ``Function``
(``FlashAttentionFn``) whose forward is the same kernel (or the plain
version) asked also for each row's log-sum-exp, ``lse`` f32 [B, Hq, S], and
whose backward is ``flash_attention_backward`` reading that lse: on a CUDA
tensor the kernels of ``csrc/flash_attention_bwd.cu`` (bf16 up to dh 512 on
wgmma fed by TMA, f32 up to 256 on the tensor cores in three TF32 passes,
f32 past 256 and bf16 past 512 on a wide CUDA-core pair; any dh;
``backward_plan`` says which), on a CPU tensor
``flash_attention_backward_plain``. Neither backward differentiates through
the plain forward. Without grad (serving) the call takes the path above,
with the same launches and no lse.

Replaces (TPU): ``src/repro/kernels/flash_attention.py::flash_attention_pallas``;
the plain version is the port of the chunked online softmax of
``src/repro/models/attention.py::flash_attention``, which the reference
runs on this path. Both put query row i at position i (left-aligned) and
keep key j for row i iff j < T, j <= i when causal, and j > i - window when
window > 0; a row that keeps no key returns 0. What bounds the kernel on
the H100 (operations, 4·dh per kept pair) and what its design does about it
is in the CUDA source.

A ``meta`` tensor (the dry run) launches nothing: the forward and the
backward return empty outputs (lse included) and charge ``cost.charge``
with 4·dh (forward) or 10·dh (backward) operations a kept pair and query
head at the input type, and their operands and outputs at its size
(``_meta_forward``, ``_meta_backward``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import cost as _cost

NEG_INF = float(-3.0e38)  # models/attention.py's sentinel (the scan kernels use -3.4e38)
# widest compiled width of the tiled kernels: dh is zero-padded to a multiple of 8 here, then up to
# 64/128/256 in bf16 (TMA's fill) and 32/64/128/256 in f32 (the cp.async staging's)
MAX_HEAD_DIM = 256
# widest bf16 head the backward runs on wgmma (DH 64 and 128 the wgmma pair,
# 256, 384 and 512 the split pair): past it a block's 64 stationary rows of
# two operands (128 KiB at 512) leave no room for a ring of two stages
WGMMA_BWD_MAX = 512
# the wgmma backward by padded width DH (WgTile, SplitTile): keys a dQ tile and
# its ring stages, queries a dK/dV tile and its stages, dK/dV columns a slice
_BWD_WGMMA = {64: (64, 4, 64, 4, 64), 128: (64, 3, 32, 4, 128), 256: (64, 2, 64, 2, 256),
              384: (32, 2, 32, 2, 192), 512: (16, 2, 16, 2, 256)}
# the f32 backward up to dh 256 on 3xTF32 mma.sync by compiled width DH (TfTile):
# m16 tiles a warp (a block's 8 warps hold 64 x that query rows or keys), keys a
# dQ tile and its ring stages, queries a dK/dV tile and its stages
_BWD_TF32 = {32: (1, 64, 3, 64, 3), 64: (2, 64, 2, 32, 3), 128: (1, 64, 2, 64, 2), 256: (1, 16, 2, 16, 2)}
# the wide backward pair (WidePlan): stationary rows a block, moving rows a tile,
# columns of an S/dP chunk, moving rows of an accumulating chunk, ring stages,
# output columns a slice at most
_WIDE_R, _WIDE_M, _WIDE_C, _WIDE_Q, _WIDE_STAGES, _WIDE_COLS = 32, 64, 32, 4, 3, 512
SMEM_MAX = 232448  # dynamic shared bytes a block may hold on the H100
# widest bf16 head the wide path runs on the tensor cores (DH 384 and 512): past it
# a wgmma block's 128-row Q tile would outgrow shared memory beside its K/V ring
WIDE_WGMMA_MAX = 512
# flash_sliced_kernel (csrc/flash_attention.cu): threads, query rows and keys a tile,
# and Q/K columns staged at once; the row padding of its transposed tiles
_SLICED_THREADS, _SLICED_BQ, _SLICED_BK, _SLICED_DC, _PAD = 256, 64, 64, 32, 4
# flash_fwd_wgmma_kernel at DH 384 / 512 (Tile, Smem): keys a K/V tile, ring stages,
# output columns a block
_WGMMA_WIDE = {384: (32, 3, 192), 512: (32, 2, 256)}


def wide_head(dh: int) -> bool:
    """Whether a head width takes ``flash_attention_wide``: the tiled
    kernels' tiles at the next width above 256 (512) would exceed the 227
    KiB of shared memory a block may hold (the f32 kernel's split Q alone
    would take 256 KiB, ``FwdSmem``; the bf16 kernel's Q tile 128 KiB beside
    a ring of two 128 KiB K/V stages), and a warpgroup's 64 x 512 output 256
    registers a thread."""
    return int(dh) > MAX_HEAD_DIM


def sliced_cols(dh: int) -> int:
    """Output columns each half of a ``flash_sliced_kernel`` block owns
    (mirrors ``sliced_cols``): dh in the fewest blocks of at most 512
    columns, each in two halves rounded up to a multiple of 32."""
    n = -(-dh // 512)
    return -(-(-(-dh // (2 * n))) // 32) * 32


def wide_launch_shape(b: int, s: int, hq: int, dh: int, elem_size: int) -> tuple[int, ...]:
    """(grid x, y, z, threads, dynamic shared bytes, keys a K/V tile, output
    columns a block) of ``flash_attention_wide``'s launch (mirrors
    ``flash_attention_wide_shape``). bf16 up to ``WIDE_WGMMA_MAX``: the
    wgmma kernel at DH 384 or 512, one block per (128 query rows, head,
    batch, column slice), 384 threads, Q [128, DH] and a ring of K [32, DH]
    and V [32, DV] tiles in bf16 (``Smem``). Otherwise the sliced CUDA-core
    kernel: 256 threads and 64 query rows a block, y holding heads x blocks
    of two DV-column halves, Q and K chunks of 32 columns, P, a V tile of
    the block's columns and two per-row arrays in f32."""
    if elem_size == 2 and dh <= WIDE_WGMMA_MAX:
        width = 384 if dh <= 384 else 512
        bn, stages, dv = _WGMMA_WIDE[width]
        smem = 1024 + 128 * width * 2 + stages * (bn * width * 2 + bn * dv * 2) + (1 + 3 * stages) * 8
        return (-(-s // 128) * hq * b * -(-dh // dv), 1, 1, 384, smem, bn, dv)
    dv = sliced_cols(dh)
    smem = (2 * _SLICED_DC * (_SLICED_BQ + _PAD) + _SLICED_BK * (_SLICED_BQ + _PAD) + _SLICED_BK * 2 * dv
            + 2 * _SLICED_BQ) * 4
    return (-(-s // _SLICED_BQ), hq * -(-dh // (2 * dv)), b, _SLICED_THREADS, smem, _SLICED_BK, dv)


def _wide_bwd_side(dp: int, esize: int, dkdv: bool) -> tuple[int, int, int, int, int]:
    """(slices, columns a slice, dynamic shared bytes, stationary, dh rounded
    up to a chunk) of one kernel of the wide backward pair (mirrors
    ``wide_plan``): the stationary rows over all of dh staged once when they
    fit beside the ring and the P/dS tiles, else streamed by chunks."""
    pad = 16 // esize
    slices = -(-dp // _WIDE_COLS)
    cols = -(-(-(-dp // slices)) // 8) * 8
    nu = -(-cols // 128)
    dhc = -(-dp // _WIDE_C) * _WIDE_C
    nops = 2 if dkdv else 1
    w_bytes = nops * _WIDE_M * (_WIDE_R + 4) * 4 + (0 if dkdv else _WIDE_R * 4)
    stat_bytes = 2 * _WIDE_R * (dhc + pad) * esize
    p2 = nops * _WIDE_Q * (128 * nu + pad)
    for stationary in (1, 0):
        p1 = 2 * _WIDE_M * (_WIDE_C + pad) + (0 if stationary else 2 * _WIDE_R * (_WIDE_C + pad))
        stage = -(-max(p1, p2) * esize // 16) * 16
        smem = (stat_bytes if stationary else 0) + _WIDE_STAGES * stage + w_bytes
        if smem <= SMEM_MAX:
            break
    return slices, cols, smem, stationary, dhc


def backward_plan(dh: int, elem_size: int) -> dict:
    """The launch plan of ``flash_attention_backward`` for a head width and
    element size (mirrors the C entry's ``flash_attention_bwd_plan``, which
    a card test holds it to): ``route`` (``wgmma``: bf16 up to 128, DH 64 or
    128; ``wgmma_split``: bf16 129..512, DH 256, 384 or 512, the two
    consumer warpgroups splitting the products; ``tf32x3``: f32 up to 256,
    DH 32, 64, 128 or 256, on the tensor cores in three TF32 passes;
    ``wide``: f32 past 256 and bf16 past 512 on CUDA cores), ``dp`` (the
    width the wrapper hands the kernels: dh padded to a multiple of 8),
    ``width`` (compiled; the wide pair's dh rounded up to its chunk), each
    kernel's column slices and dynamic shared bytes, ``threads``, the wide pair's ``stationary``
    flags (dq, dk/dv), ``cols`` (columns a dk/dv slice) and ``regs``, the
    wgmma consumers' registers a thread for accumulators and operands (dq,
    dk/dv), which setmaxnreg caps at 240."""
    bf16 = elem_size == 2
    dp8 = -(-dh // 8) * 8
    out = {"stationary": (0, 0), "regs": None}
    if bf16 and dh <= WGMMA_BWD_MAX:
        split = dh > 128
        width = (64 if dh <= 64 else 128) if not split else (256 if dh <= 256 else 384 if dh <= 384 else 512)
        bn, dq_st, bq, kv_st, dv = _BWD_WGMMA[width]
        if split:  # 64 stationary rows a block; P (and dS) handed across in shared memory
            dq_smem = 1024 + 2 * 64 * width * 2 + dq_st * 2 * bn * width * 2 + bn // 2 * 512 + bn // 16 * 2048 \
                + (5 + 2 * dq_st) * 8
            kv_smem = 1024 + 2 * 64 * width * 2 + kv_st * (2 * bq * width * 2 + 2 * bq * 4) + bq // 2 * 512 \
                + (3 + 2 * kv_st) * 8
            regs = (width // 4 + bn // 2 + bn // 4, dv // 2 + bq // 2 + bq // 4)
        else:  # 128 stationary rows a block, 64 a consumer warpgroup
            dq_smem = 1024 + 2 * 128 * width * 2 + dq_st * 2 * bn * width * 2 + (1 + 2 * dq_st) * 8
            kv_smem = 1024 + 2 * 128 * width * 2 + kv_st * (2 * bq * width * 2 + 2 * bq * 4) + (1 + 2 * kv_st) * 8
            regs = (width // 2 + bn + bn // 4, width + bq + bq // 2)
        out.update(route="wgmma_split" if split else "wgmma", dp=dp8, width=width, dq_slices=1,
                   dkdv_slices=width // dv, dq_smem=dq_smem, dkdv_smem=kv_smem, threads=384, cols=dv, regs=regs)
    elif not bf16 and dh <= MAX_HEAD_DIM:
        width = 32 if dh <= 32 else 64 if dh <= 64 else 128 if dh <= 128 else 256
        mt, bn, dq_st, bq, kv_st = _BWD_TF32[width]
        ld = width + _PAD  # row stride (floats) of every staged tile
        dq_smem = 2 * 64 * mt * ld * 4 + dq_st * 2 * bn * ld * 4  # Q and dO, the K/V ring
        # K and V, the ring of Q/dO/lse/D tiles, the P hand-over
        kv_smem = 2 * 64 * mt * ld * 4 + kv_st * (2 * bq * ld + 2 * bq) * 4 + 4 * mt * (bq // 8) * 32 * 16
        out.update(route="tf32x3", dp=dp8, width=width, dq_slices=1, dkdv_slices=1, dq_smem=dq_smem,
                   dkdv_smem=kv_smem, threads=256, cols=width)
    else:
        sq, cols, mq, st_q, dhc = _wide_bwd_side(dp8, elem_size, False)
        skv, _, mkv, st_kv, _ = _wide_bwd_side(dp8, elem_size, True)
        out.update(route="wide", dp=dp8, width=dhc, dq_slices=sq, dkdv_slices=skv, dq_smem=mq, dkdv_smem=mkv,
                   threads=256, cols=cols, stationary=(st_q, st_kv))
    return out


def flash_attention_plain(
    q: torch.Tensor,  # [B, S, Hq, dh]
    k: torch.Tensor,  # [B, T, Hkv, dh]
    v: torch.Tensor,  # [B, T, Hkv, dh]
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    return_lse: bool = False,
):
    """Double-chunked online-softmax attention in f32 (the reference's
    ``models.attention.flash_attention`` with ``q_offset=0``). KV chunks that
    no row of a query chunk keeps are skipped, and masked entries add p = 0;
    for every row that keeps a key both leave the result as the reference's
    (its skipped chunks are scaled by exactly 0 once a kept key arrives).
    With ``return_lse`` it returns ``(o, lse)``: lse f32 [B, Hq, S] is each
    row's m + log l, the log-sum-exp of its kept logits (NEG_INF for a row
    that keeps no key)."""
    flash_attention_plain.calls += 1
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh**-0.5
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    qf = (q.to(torch.float32) * scale).reshape(b, s, hkv, g, dh)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty((b, s, hkv, g, dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hkv, g, s), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, qc):
        q1 = min(q0 + qc, s)
        q_pos = torch.arange(q0, q1, device=q.device)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(t, q1) if causal else t
        m = torch.full((b, hkv, g, q1 - q0), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hkv, g, q1 - q0, dh), dtype=torch.float32, device=q.device)
        for k0 in range((lo // kc) * kc, hi, kc):
            k1 = min(k0 + kc, t)
            k_pos = torch.arange(k0, k1, device=q.device)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, q0:q1], kf[:, k0:k1])
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            logits = logits.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None]).masked_fill(~mask, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vf[:, k0:k1])
            m = m_new
        res = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q1] = res.permute(0, 3, 1, 2, 4)
        lse[..., q0:q1] = m + torch.log(torch.clamp(l, min=1e-30))
    o = out.reshape(b, s, hq, dh).to(q.dtype)
    return (o, lse.reshape(b, hq, s)) if return_lse else o


flash_attention_plain.calls = 0


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q [B,S,Hq,dh], k/v [B,T,Hkv,dh]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh or hq % k.shape[2] != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} (Hq must be a multiple of Hkv)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, {k.device}, {v.device}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    return_lse: bool = False,
):
    """See the module docstring. ``window`` 0 is global attention.
    ``q_chunk``/``kv_chunk`` are the plain version's chunks (CPU tensors);
    the kernels tile by their own sizes (bf16: 128 queries and 64 or 128
    keys; f32: 64 or 128 queries and 64 or 16 keys, ``FwdTile``). Under grad, with an input that requires grad,
    the result's ``grad_fn`` is ``FlashAttentionFn``'s. ``return_lse``
    (outside grad: for calling ``flash_attention_backward`` by hand) returns
    ``(o, lse)``, the same o and each row's log-sum-exp, f32 [B, Hq, S]."""
    _check(q, k, v)
    window = int(window)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if return_lse:
        if grad:
            raise ValueError("return_lse gives a result autograd cannot see; under grad the "
                             "Function saves lse itself")
        return _forward(q, k, v, causal, window, q_chunk, kv_chunk, with_lse=True)
    if grad:
        return FlashAttentionFn.apply(q, k, v, bool(causal), window, q_chunk, kv_chunk)
    return _forward(q, k, v, causal, window, q_chunk, kv_chunk)


def _forward(q, k, v, causal: bool, window: int, q_chunk: int, kv_chunk: int, with_lse: bool = False):
    """The forward of ``flash_attention`` on checked operands: the kernel on
    a CUDA tensor, the plain version on a CPU tensor; ``(o, lse)`` when
    ``with_lse``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk, return_lse=with_lse)
    if q.device.type == "meta":
        return _meta_forward(q, k, v, causal, window, with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    B, S, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.numel() == 0 or T == 0:
        o = torch.zeros_like(q)
        return (o, torch.full((B, Hq, S), NEG_INF, dtype=torch.float32, device=q.device)) if with_lse else o
    if wide_head(dh):
        return flash_attention_wide(q, k, v, causal=causal, window=window, return_lse=with_lse)
    bf16 = q.dtype == torch.bfloat16
    # Both kernels read whole 16-byte rows (bf16 by TMA, f32 by cp.async) and
    # the f32 kernel writes o as float4s: other widths are zero-padded to a
    # multiple of 8 on the card (zero columns add nothing to q·k and give
    # zero outputs, which are cut off), and misaligned bases are copied.
    dp = -(-dh // 8) * 8
    if dp != dh:
        q, k, v = (torch.nn.functional.pad(x, (0, dp - dh)) for x in (q, k, v))
    elif any(x.data_ptr() % 16 for x in (q, k, v)):
        q, k, v = (x.clone() for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
            B, S, T, Hq, Hkv, dp, int(bool(causal)), window, dh**-0.5,
            int(bf16), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    o = o if dp == dh else o[..., :dh].contiguous()
    return (o, lse) if with_lse else o


flash_attention.launches = 0


def kept_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps: row i (left-aligned) keeps keys in
    [max(0, i - window + 1), min(i, T - 1)] (the upper end T - 1 when not
    causal; the lower 0 when ``window`` is 0)."""
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(s, dtype=np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def _meta_forward(q, k, v, causal: bool, window: int, with_lse: bool):
    """The forward's answer to meta tensors: empty o (and lse), charged 4·dh
    operations a kept pair and query head, q, k, v read and o (lse) written
    once."""
    B, S, Hq, dh = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) if with_lse else None
    flops = 4.0 * dh * Hq * B * kept_pairs(S, k.shape[1], causal, window)
    name = "flash_attention_wide" if wide_head(dh) else "flash_attention"
    _cost.charge(name, flops, q.dtype, (q, k, v), (o,) if lse is None else (o, lse))
    return (o, lse) if with_lse else o


def flash_attention_wide(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
    return_lse: bool = False,
):
    """The kernels past ``MAX_HEAD_DIM``, which ``flash_attention`` takes
    after checking the operands (contiguous, CUDA): O in column slices of at
    most 256 (a block each), the logits summed over dh in slices. bf16 up to
    ``WIDE_WGMMA_MAX``: ``flash_fwd_wgmma_kernel`` at DH 384 or 512 (dh
    zero-padded to a multiple of 8 here for TMA's strides, then to DH by
    TMA's fill); f32, and bf16 past it: ``flash_sliced_kernel`` on CUDA
    cores. Any dh; one launch; ``(o, lse)`` with ``return_lse``."""
    B, S, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    dp = -(-dh // 8) * 8 if bf16 and dh <= WIDE_WGMMA_MAX else dh
    if dp != dh:
        q, k, v = (torch.nn.functional.pad(x, (0, dp - dh)) for x in (q, k, v))
    elif bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        q, k, v = (x.clone() for x in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device) if return_lse else None
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_wide_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr(),
            B, S, T, Hq, Hkv, dp, int(bool(causal)), int(window), dh**-0.5,
            int(bf16), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "flash_attention_wide")
    flash_attention_wide.launches += 1
    o = o if dp == dh else o[..., :dh].contiguous()
    return (o, lse) if return_lse else o


flash_attention_wide.launches = 0


# ---------------------------------------------------------------- backward


def flash_attention_backward_plain(
    q: torch.Tensor,  # [B, S, Hq, dh]
    k: torch.Tensor,  # [B, T, Hkv, dh]
    v: torch.Tensor,  # [B, T, Hkv, dh]
    o: torch.Tensor,  # [B, S, Hq, dh], the forward's output
    do: torch.Tensor,  # [B, S, Hq, dh], the gradient of the loss w.r.t. o
    lse: torch.Tensor | None = None,  # [B, Hq, S] f32, the forward's log-sum-exp
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_plain`` in f32, chunked as it is,
    cast to the inputs' type. Per query chunk: each row's lse (the forward's
    ``return_lse``; with ``lse=None`` a first sweep over the KV chunks
    recomputes it from the forward's max m and sum l, lse = m + log l), then
    a sweep recomputes P = exp(S - lse) on the kept entries and accumulates,
    with D_i = rowsum(dO ∘ O): dS = P ∘ (dO·Vᵀ - D), dQ += scale·dS·K,
    dK += scale·dSᵀ·Q, dV += Pᵀ·dO. Masked entries carry P = 0, so a row
    that keeps no key (its output is the constant 0) gets zero gradients and
    adds nothing to dK and dV, whatever its lse."""
    flash_attention_backward_plain.calls += 1
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh**-0.5
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    qf = q.to(torch.float32).reshape(b, s, hkv, g, dh)
    dof = do.to(torch.float32).reshape(b, s, hkv, g, dh)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    delta = (dof * o.to(torch.float32).reshape(b, s, hkv, g, dh)).sum(-1).permute(0, 2, 3, 1)  # [b,h,g,s]
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    given = None if lse is None else lse.to(torch.float32).reshape(b, hkv, g, s)
    for q0 in range(0, s, qc):
        q1 = min(q0 + qc, s)
        q_pos = torch.arange(q0, q1, device=q.device)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(t, q1) if causal else t
        qs = qf[:, q0:q1] * scale
        chunks = []
        for k0 in range((lo // kc) * kc, hi, kc):
            k1 = min(k0 + kc, t)
            k_pos = torch.arange(k0, k1, device=q.device)
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=q.device)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            chunks.append((k0, k1, mask))

        def logits_of(k0, k1, mask):
            x = torch.einsum("bqhgd,bkhd->bhgqk", qs, kf[:, k0:k1])
            return x.masked_fill(~mask, NEG_INF)

        if given is None:
            m = torch.full((b, hkv, g, q1 - q0), NEG_INF, dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            for k0, k1, mask in chunks:  # the forward's row statistics
                x = logits_of(k0, k1, mask)
                m_new = torch.maximum(m, x.amax(dim=-1))
                p = torch.exp(x - m_new[..., None]).masked_fill(~mask, 0.0)
                l = l * torch.exp(m - m_new) + p.sum(dim=-1)
                m = m_new
            lse_c = m + torch.log(torch.clamp(l, min=1e-30))
        else:
            lse_c = given[..., q0:q1]
        d_rows = delta[..., q0:q1]
        dq_c = torch.zeros((b, q1 - q0, hkv, g, dh), dtype=torch.float32, device=q.device)
        for k0, k1, mask in chunks:
            p = torch.exp(logits_of(k0, k1, mask) - lse_c[..., None]).masked_fill(~mask, 0.0)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dof[:, q0:q1], vf[:, k0:k1])
            ds = p * (dp - d_rows[..., None])
            dq_c += torch.einsum("bhgqk,bkhd->bqhgd", ds, kf[:, k0:k1]) * scale
            dk[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
            dv[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", p, dof[:, q0:q1])
        dq[:, q0:q1] = dq_c
    return dq.reshape(b, s, hq, dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_backward_plain.calls = 0


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor | None = None,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` in the inputs' type, from the
    forward's output ``o`` and its ``lse`` (``flash_attention(...,
    return_lse=True)``, or what ``FlashAttentionFn`` saved). On a CUDA tensor
    one call of ``csrc/flash_attention_bwd.cu``, which needs lse (it raises
    without it: the kernels do not recompute the statistics): two kernels on
    the current stream, D and dQ per query tile, then dK and dV per key tile;
    f32 sums, no atomics, so the result is deterministic. The design is
    ``backward_plan``'s: bf16 up to dh ``WGMMA_BWD_MAX`` on wgmma, f32 up to
    ``MAX_HEAD_DIM`` on the 3xTF32 tensor-core pair, wider heads on the wide
    CUDA-core pair; any dh. Every route reads whole 16-byte rows, so dh is
    zero-padded to a multiple of 8 and misaligned bases are copied here (as
    the forward does). On a CPU tensor ``flash_attention_backward_plain``
    (lse optional). ``launches`` counts the CUDA calls."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    B, S, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if lse is not None and (tuple(lse.shape) != (B, Hq, S) or lse.device != q.device):
        raise ValueError(f"lse {tuple(lse.shape)} on {lse.device} must be [B, Hq, S] = {(B, Hq, S)} on {q.device}")
    window = int(window)
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, o, do.to(q.dtype), lse, causal=causal, window=window,
                                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.device.type == "meta":
        return _meta_backward(q, k, v, o, do, lse, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward runs on cuda or cpu tensors, got {q.device}")
    if lse is None:
        raise ValueError("flash_attention_backward on the card reads the forward's lse: pass "
                         "flash_attention(..., return_lse=True)'s")
    q, k, v, o = (x.contiguous() for x in (q, k, v, o))
    do = do.to(q.dtype).contiguous()
    lse = lse.to(torch.float32).contiguous()
    bf16 = q.dtype == torch.bfloat16
    # The wgmma pairs read q, k, v and dO with TMA (16-byte row strides and
    # bases) and o 16 bytes at a time, the 3xTF32 and wide pairs every
    # operand by 16-byte cp.async: pad dh to a multiple of 8 (zero columns add
    # nothing to S or dP and give zero gradients, cut off below) and copy
    # misaligned bases.
    plan = backward_plan(dh, q.element_size())
    dp = plan["dp"]
    if dp != dh:
        q, k, v, o, do = (torch.nn.functional.pad(x, (0, dp - dh)) for x in (q, k, v, o, do))
    elif any(x.data_ptr() % 16 for x in (q, k, v, o, do)):
        q, k, v, o, do = (x.clone() for x in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or T == 0:
        dq, dk, dv = dq.zero_(), dk.zero_(), dv.zero_()
    else:
        delta = torch.empty_like(lse)
        lib = _build.library("flash_attention_bwd")
        with torch.cuda.device(q.device):
            rc = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                B, S, T, Hq, Hkv, dp, int(bool(causal)), window, dh**-0.5,
                int(bf16), torch.cuda.current_stream(q.device).cuda_stream,
            )
        _build.check(lib, rc, "flash_attention_backward")
        flash_attention_backward.launches += 1
    if dp != dh:
        dq, dk, dv = (x[..., :dh].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


flash_attention_backward.launches = 0


def _meta_backward(q, k, v, o, do, lse, causal: bool, window: int):
    """The backward's answer to meta tensors: empty dq, dk, dv, charged 10·dh
    operations a kept pair and query head (S recomputed, dP, dV, dQ, dK), its
    operands read and the gradients written once."""
    B, S, Hq, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    flops = 10.0 * dh * Hq * B * kept_pairs(S, k.shape[1], causal, window)
    reads = (q, k, v, o, do) if lse is None else (q, k, v, o, do, lse)
    _cost.charge("flash_attention_backward", flops, q.dtype, reads, (dq, dk, dv))
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward kernel (or plain
    version) forward, asked for each row's lse; ``flash_attention_backward``
    backward. Saves q, k, v, the output and lse; the backward recomputes P
    from lse. Under ``torch.utils.checkpoint`` the forward reruns in the
    backward and saves lse again."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_chunk: int, kv_chunk: int):
        o, lse = _forward(q, k, v, causal, window, q_chunk, kv_chunk, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, do, lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None
