"""Forward flash attention: online softmax, causal and sliding-window masks,
grouped-query heads (the prefill hot path of the LM serving path).

``flash_attention`` takes ``q [B, S, Hq, dh]``, ``k``/``v [B, T, Hkv, dh]``
(f32 or bf16, one type) and returns ``[B, S, Hq, dh]`` in q's type. On a
CUDA tensor it launches a kernel of ``csrc/flash_attention.cu`` (or raises):
bf16 inputs the tensor-core kernel (wgmma products, K/V tiles through a TMA
ring), f32 inputs the CUDA-core kernel; past ``MAX_HEAD_DIM`` the same two
designs with O in column slices of at most 256 and the logits summed over
dh in slices (``flash_attention_wide``: bf16 up to ``WIDE_WGMMA_MAX`` on
the tensor cores, f32 and wider bf16 on CUDA cores). On a CPU tensor it
runs the plain version, ``flash_attention_plain``. ``launches`` on the
wrapper counts the tiled kernels' launches, ``flash_attention_wide.launches``
the wide ones', and ``calls`` on the plain version its calls.

Replaces (TPU): ``src/repro/kernels/flash_attention.py::flash_attention_pallas``;
the plain version is the port of the chunked online softmax of
``src/repro/models/attention.py::flash_attention``, which the reference
runs on this path. Both put query row i at position i (left-aligned) and
keep key j for row i iff j < T, j <= i when causal, and j > i - window when
window > 0; a row that keeps no key returns 0. What bounds the kernel on
the H100 (operations, 4·dh per kept pair) and what its design does about it
is in the CUDA source.
"""
from __future__ import annotations

import torch

from . import _build

NEG_INF = float(-3.0e38)  # models/attention.py's sentinel (the scan kernels use -3.4e38)
MAX_HEAD_DIM = 256  # widest compiled width of the tiled kernels (dh is zero-padded up to 64/128/256 in bf16, 32/64/128/256 in f32)
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
    KiB of shared memory a block may hold (the f32 kernel's would need 289
    KiB, ``flash_smem_bytes``; the bf16 kernel's Q tile alone 128 KiB beside
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


def flash_attention_plain(
    q: torch.Tensor,  # [B, S, Hq, dh]
    k: torch.Tensor,  # [B, T, Hkv, dh]
    v: torch.Tensor,  # [B, T, Hkv, dh]
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Double-chunked online-softmax attention in f32 (the reference's
    ``models.attention.flash_attention`` with ``q_offset=0``). KV chunks that
    no row of a query chunk keeps are skipped, and masked entries add p = 0;
    for every row that keeps a key both leave the result as the reference's
    (its skipped chunks are scaled by exactly 0 once a kept key arrives)."""
    flash_attention_plain.calls += 1
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh**-0.5
    qc, kc = min(q_chunk, s), min(kv_chunk, t)
    qf = (q.to(torch.float32) * scale).reshape(b, s, hkv, g, dh)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    out = torch.empty((b, s, hkv, g, dh), dtype=torch.float32, device=q.device)
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
    return out.reshape(b, s, hq, dh).to(q.dtype)


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
) -> torch.Tensor:
    """See the module docstring. ``window`` 0 is global attention.
    ``q_chunk``/``kv_chunk`` are the plain version's chunks (CPU tensors);
    the kernels tile by their own sizes (bf16: 128 queries and 64 or 128
    keys; f32: 64 and 64)."""
    _check(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    B, S, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if q.numel() == 0 or T == 0:
        return torch.zeros_like(q)
    if wide_head(dh):
        return flash_attention_wide(q, k, v, causal=causal, window=window)
    bf16 = q.dtype == torch.bfloat16
    # The bf16 kernel reads q, k and v with TMA, whose row strides must be
    # multiples of 16 bytes: other widths are zero-padded to a multiple of 8
    # on the card (zero columns add nothing to q·k and give zero outputs,
    # which are cut off). TMA also wants 16-byte aligned bases.
    dp = -(-dh // 8) * 8 if bf16 else dh
    if dp != dh:
        q, k, v = (torch.nn.functional.pad(x, (0, dp - dh)) for x in (q, k, v))
    elif bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        q, k, v = (x.clone() for x in (q, k, v))
    o = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, T, Hq, Hkv, dp, int(bool(causal)), window, dh**-0.5,
            int(bf16), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return o if dp == dh else o[..., :dh].contiguous()


flash_attention.launches = 0


def flash_attention_wide(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True, window: int = 0,
) -> torch.Tensor:
    """The kernels past ``MAX_HEAD_DIM``, which ``flash_attention`` takes
    after checking the operands (contiguous, CUDA): O in column slices of at
    most 256 (a block each), the logits summed over dh in slices. bf16 up to
    ``WIDE_WGMMA_MAX``: ``flash_fwd_wgmma_kernel`` at DH 384 or 512 (dh
    zero-padded to a multiple of 8 here for TMA's strides, then to DH by
    TMA's fill); f32, and bf16 past it: ``flash_sliced_kernel`` on CUDA
    cores. Any dh; one launch."""
    B, S, Hq, dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    dp = -(-dh // 8) * 8 if bf16 and dh <= WIDE_WGMMA_MAX else dh
    if dp != dh:
        q, k, v = (torch.nn.functional.pad(x, (0, dp - dh)) for x in (q, k, v))
    elif bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        q, k, v = (x.clone() for x in (q, k, v))
    o = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        rc = lib.flash_attention_wide_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, T, Hq, Hkv, dp, int(bool(causal)), int(window), dh**-0.5,
            int(bf16), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "flash_attention_wide")
    flash_attention_wide.launches += 1
    return o if dp == dh else o[..., :dh].contiguous()


flash_attention_wide.launches = 0
