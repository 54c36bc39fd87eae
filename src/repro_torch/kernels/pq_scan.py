"""ADC scan (PQ lookup-table scores) + top-k over uint8 codes.

Three wrappers over the one CUDA kernel of ``csrc/pq_scan.cu``, each named
and shaped as the Pallas kernel it replaces (``repro.kernels.pq_scan``):

  * ``workunit_pq_scan_streamed`` — the engine's segmented path: each unit
    slot's LUT row is read from the resident table ``[U, M, 256]`` through
    ``lut_idx [W, TQ]``, so no ``[W, TQ, M, 256]`` operand exists;
  * ``workunit_pq_scan`` — the dense layout: per-unit expanded LUTs
    ``[W, TQ, M, 256]``;
  * ``pq_scan`` — one query's LUT ``[M, 256]`` against ``NV`` code rows, the
    rows split over about one block per SM.

``score[q, v] = Σ_m lut[q, m, code[v, m]]`` (summed in the order m = 0 …
M-1, see ``ref.adc_scores_ref``), rows with ``valid`` false never
candidates, ranks (score desc, row asc), ``(NEG_INF, -1)`` where no valid
row fills a slot; row indices are local to the unit (to ``codes`` for
``pq_scan``). A CUDA tensor launches the kernel (or the wrapper raises); a
CPU tensor takes the plain version (``*_plain``, each with a ``calls``
counter). ``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref
from .fused_knn import MAX_K, SMEM_OPTIN_BYTES

SPLIT_ROWS = 1024  # rows per block of a work unit beyond which its rows split over blocks
NBOOK = 256  # entries per PQ codebook (8-bit codes)
_THREADS, _CODE_ROWS, _LUT_PAD = 256, 256, 4  # kThreads, kCodeRows, kLutPad of csrc/pq_scan.cu
_ONE_QUERY_BLOCKS = 132  # pq_scan splits its rows over about one block per SM (H100: 132)


def pick_qb(m: int, tq: int) -> int:
    """Queries per block: the largest power of two with qb·M ≤ 64 (64 KiB of
    LUT rows in shared memory, whatever M), and no more than TQ needs."""
    qb = 1
    while 2 * qb * m <= 64 and qb < tq:
        qb *= 2
    return qb


def adc_smem_bytes(m: int, qb: int, k: int) -> int:
    """Dynamic shared memory of one ADC block (mirrors ``adc_smem_bytes`` in
    ``csrc/pq_scan.cu``): the chunk's LUT rows plus a code and valid tile, or
    the lane-fold area, whichever is larger."""
    kb = next(b for b in (8, 16, 32, 64) if k <= b)
    tile = qb * (m * NBOOK + _LUT_PAD) * 4 + _CODE_ROWS * m + _CODE_ROWS
    return max(tile, _THREADS * (kb * 8 + 4))


# widest M the kernel takes: one query's LUT row and the code tile in shared memory
MAX_M = max(m for m in range(1, 1024) if adc_smem_bytes(m, 1, MAX_K) <= SMEM_OPTIN_BYTES)


def check_pq_kernel_limits(k: int, m: int, qb: int) -> None:
    """Raise ``ValueError`` for a problem the ADC kernel cannot take: k above
    ``MAX_K`` (register lists), or M whose LUT chunk of ``qb`` queries does
    not fit shared memory (the widest is ``MAX_M`` at one query a block). The
    plain versions, on the CPU, have neither limit."""
    if k > MAX_K:
        raise ValueError(f"k={k}: the ADC kernels take k <= {MAX_K} (with refine_factor, "
                         f"k' = refine_factor·k); use a smaller k or refine_factor, or an "
                         f"index on the CPU")
    need = adc_smem_bytes(m, qb, k)
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(f"M={m}: the ADC kernel's LUT chunk of {qb} queries needs {need} "
                         f"bytes of shared memory, above {SMEM_OPTIN_BYTES} (the widest M "
                         f"is {MAX_M}); use an index on the CPU")


# ------------------------------------------------------------ plain versions


def workunit_pq_scan_plain(luts, codes, valid, *, k: int):
    """Plain version of ``workunit_pq_scan``: ``ref.workunit_pq_topk_ref``."""
    workunit_pq_scan_plain.calls += 1
    return _ref.workunit_pq_topk_ref(luts, codes, valid, int(k))


def workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, *, k: int):
    """Plain version of ``workunit_pq_scan_streamed``:
    ``ref.workunit_pq_topk_resident_ref``."""
    workunit_pq_scan_streamed_plain.calls += 1
    return _ref.workunit_pq_topk_resident_ref(table, lut_idx, codes, valid, int(k))


def pq_scan_plain(lut, codes, valid, *, k: int):
    """Plain version of ``pq_scan``: ``ref.adc_topk_ref`` for one query."""
    pq_scan_plain.calls += 1
    s, i = _ref.adc_topk_ref(lut[None], codes, valid, int(k))
    return s[0], i[0]


workunit_pq_scan_plain.calls = 0
workunit_pq_scan_streamed_plain.calls = 0
pq_scan_plain.calls = 0


# ------------------------------------------------------------------ checks


def _check_codes(codes, valid, m: int, k: int) -> None:
    """codes uint8 [..., TV, M] with valid bool [..., TV] and 1 <= k <= TV."""
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if codes.shape[-1] != m or tuple(valid.shape) != tuple(codes.shape[:-1]):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, valid "
                         f"{tuple(valid.shape)}, M={m}")
    if not 1 <= k <= codes.shape[-2]:
        raise ValueError(f"k={k} outside [1, TV={codes.shape[-2]}]")


def _check_lut(lut, lead: tuple) -> None:
    """f32 LUTs [*lead, M, 256]."""
    if lut.dtype != torch.float32:
        raise TypeError(f"LUTs must be float32, got {lut.dtype}")
    if tuple(lut.shape[:len(lead)]) != lead or lut.shape[-1] != NBOOK or lut.dim() != len(lead) + 2:
        raise ValueError(f"LUTs {tuple(lut.shape)}: want {lead + ('M', NBOOK)}")


def _same_device(*tensors) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


# ------------------------------------------------------------------ launch


def _launch(lut, lut_idx, codes, valid, *, k: int, W: int, TQ: int, U: int,
            chunk_rows: int, what: str):
    """Launch the ADC kernel on CUDA tensors; returns (f32 [W, TQ, k], i32
    [W, TQ, k])."""
    if codes.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {codes.device}")
    TV, M = codes.shape[-2], codes.shape[-1]
    qb = pick_qb(M, TQ)
    check_pq_kernel_limits(k, M, qb)
    tensors = [lut, codes, valid] + ([] if lut_idx is None else [lut_idx])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: every input must be contiguous")
    if lut.data_ptr() % 16:
        raise ValueError(f"{what}: the LUTs must start on a 16-byte boundary")
    out_s = torch.empty((W, TQ, k), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((W, TQ, k), dtype=torch.int32, device=codes.device)
    S = -(-TV // chunk_rows)
    part_s = torch.empty((W, S, TQ, k) if S > 1 else (0,), dtype=torch.float32, device=codes.device)
    part_i = torch.empty((W, S, TQ, k) if S > 1 else (0,), dtype=torch.int32, device=codes.device)
    lib = _build.library("pq_scan")
    with torch.cuda.device(codes.device):
        rc = lib.adc_scan_launch(
            lut.data_ptr(), None if lut_idx is None else lut_idx.data_ptr(),
            codes.data_ptr(), valid.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            W, TQ, TV, M, U, k, qb, chunk_rows,
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    _build.check(lib, rc, what)
    return out_s, out_i


def workunit_pq_scan_streamed(
    table: torch.Tensor,  # f32 [U, M, 256] — resident per-query ADC tables
    lut_idx: torch.Tensor,  # i32 [W, TQ] — table row per unit slot (0 for padding)
    codes: torch.Tensor,  # uint8 [W, TV, M] — gathered code rows per unit
    valid: torch.Tensor,  # bool [W, TV]
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Work-unit ADC scan reading each slot's LUT row from the resident
    table. Returns (scores f32 [W, TQ, k] best-first, idx i32 [W, TQ, k]).
    An index outside ``[0, U)`` is a caller's error: the plain version
    raises, the kernel clamps it into the table."""
    k = int(k)
    _check_lut(table, (table.shape[0],))
    if lut_idx.dim() != 2 or lut_idx.dtype != torch.int32:
        raise TypeError(f"lut_idx must be int32 [W, TQ], got {lut_idx.dtype} {tuple(lut_idx.shape)}")
    if codes.dim() != 3 or codes.shape[0] != lut_idx.shape[0]:
        raise ValueError(f"codes {tuple(codes.shape)} for lut_idx {tuple(lut_idx.shape)}")
    _check_codes(codes, valid, table.shape[1], k)
    _same_device(table, lut_idx, codes, valid)
    if codes.device.type == "cpu":
        return workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, k=k)
    W, TQ = lut_idx.shape
    out = _launch(table, lut_idx, codes, valid, k=k, W=W, TQ=TQ, U=table.shape[0],
                  chunk_rows=SPLIT_ROWS, what="workunit_pq_scan_streamed")
    workunit_pq_scan_streamed.launches += 1
    return out


workunit_pq_scan_streamed.launches = 0


def workunit_pq_scan(
    luts: torch.Tensor,  # f32 [W, TQ, M, 256] — per-query ADC tables per unit
    codes: torch.Tensor,  # uint8 [W, TV, M]
    valid: torch.Tensor,  # bool [W, TV]
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Work-unit ADC scan over expanded LUTs. Returns (scores f32
    [W, TQ, k] best-first, idx i32 [W, TQ, k])."""
    k = int(k)
    if luts.dim() != 4 or codes.dim() != 3:
        raise ValueError(f"want luts [W,TQ,M,256], codes [W,TV,M]; got "
                         f"{tuple(luts.shape)}, {tuple(codes.shape)}")
    _check_lut(luts, tuple(luts.shape[:2]))
    if codes.shape[0] != luts.shape[0]:
        raise ValueError(f"codes {tuple(codes.shape)} for luts {tuple(luts.shape)}")
    _check_codes(codes, valid, luts.shape[2], k)
    _same_device(luts, codes, valid)
    if codes.device.type == "cpu":
        return workunit_pq_scan_plain(luts, codes, valid, k=k)
    W, TQ = luts.shape[:2]
    out = _launch(luts, None, codes, valid, k=k, W=W, TQ=TQ, U=W * TQ,
                  chunk_rows=SPLIT_ROWS, what="workunit_pq_scan")
    workunit_pq_scan.launches += 1
    return out


workunit_pq_scan.launches = 0


def pq_scan(
    lut: torch.Tensor,  # f32 [M, 256] — one query's ADC tables
    codes: torch.Tensor,  # uint8 [NV, M]
    valid: torch.Tensor,  # bool [NV]
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-query ADC scan. Returns (scores f32 [k] best-first, idx i32 [k])."""
    k = int(k)
    if lut.dim() != 2 or codes.dim() != 2:
        raise ValueError(f"want lut [M,256], codes [NV,M]; got {tuple(lut.shape)}, "
                         f"{tuple(codes.shape)}")
    _check_lut(lut, ())
    _check_codes(codes, valid, lut.shape[0], k)
    _same_device(lut, codes, valid)
    if codes.device.type == "cpu":
        return pq_scan_plain(lut, codes, valid, k=k)
    nv = codes.shape[0]
    per_block = -(-nv // _ONE_QUERY_BLOCKS)
    chunk = max(SPLIT_ROWS, -(-per_block // _CODE_ROWS) * _CODE_ROWS)
    s, i = _launch(lut, None, codes, valid, k=k, W=1, TQ=1, U=1,
                   chunk_rows=chunk, what="pq_scan")
    pq_scan.launches += 1
    return s[0, 0], i[0, 0]


pq_scan.launches = 0
