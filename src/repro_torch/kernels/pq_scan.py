"""ADC scan (PQ lookup-table scores) + top-k over uint8 codes.

Three wrappers over the kernels of ``csrc/pq_scan.cu``, each named and
shaped as the Pallas kernel it replaces (``repro.kernels.pq_scan``):

  * ``workunit_pq_scan_streamed`` — the engine's segmented path: each unit
    slot's LUT row is read from the resident table ``[U, M, 256]`` through
    ``lut_idx [W, TQ]``, so no ``[W, TQ, M, 256]`` operand exists. A slot
    whose index is -1 holds no query. The LUT-stationary kernel: the slots
    are sorted by table row (``slot_order``), a block takes ``P`` of them in
    that order and stages each run's LUT row once;
  * ``workunit_pq_scan`` — the dense layout: per-unit expanded LUTs
    ``[W, TQ, M, 256]`` with optional ``n_live [W]`` (real slots per unit,
    the others never read). ``adc_slot_warps_kernel``: a block takes a
    unit's live slots ``G`` at a time, a warp (or ``g``) a slot, the code
    rows shared through a ``cp.async`` ring; small grids split a unit over
    blocks by slot groups, then by rows (``launch_shape``, picked by the C
    entry), and the last range to finish merges the ranges' lists in the
    same launch;
  * ``pq_scan`` — one query's LUT ``[M, 256]`` against ``NV`` code rows, the
    rows split over about one block per SM, the blocks' lists merged by the
    last block in the same launch (the LUT-stationary kernel again).

``score[q, v] = Σ_m lut[q, m, code[v, m]]`` (summed in the order m = 0 …
M-1, see ``ref.adc_scores_ref``), rows with ``valid`` false never
candidates, ranks (score desc, row asc), ``(NEG_INF, -1)`` where no valid
row fills a slot; row indices are local to the unit (to ``codes`` for
``pq_scan``). A CUDA tensor launches the kernel (or the wrapper raises); a
CPU tensor takes the plain version (``*_plain``, each with a ``calls``
counter). ``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build
from . import ref as _ref
from .fused_knn import MAX_K, SMEM_OPTIN_BYTES

NBOOK = 256  # entries per PQ codebook (8-bit codes)
# lutst::kWarps, kStages, kChunk, kMaxRange of csrc/pq_scan.cu, and topk.cuh's kSelectBuf
_WARPS, _STAGES, _CHUNK, _MAX_RANGE, _SELECT_BUF = 8, 4, 32, 128, 64
# adc::kStages of csrc/pq_scan.cu: tiles in the dense-layout kernel's ring
_ADC_STAGES = 6


def adc_smem_bytes(m: int, slots: int, warps_per_slot: int, tile: int) -> int:
    """Dynamic shared memory of one ``adc_slot_warps_kernel`` block (mirrors
    ``adc::smem_bytes`` in ``csrc/pq_scan.cu``): the LUT rows of its
    ``slots`` slots, a ring of tiles (``tile`` 32-row chunks of codes and
    mask each), a candidate buffer a warp and a flag."""
    return (slots * m * NBOOK * 4 + _ADC_STAGES * _CHUNK * tile * (m + 1)
            + slots * warps_per_slot * _SELECT_BUF * 8 + 16)


# widest M adc_slot_warps_kernel takes: one slot's LUT row, a ring of 32-row chunks, one warp
MAX_M = max(m for m in range(1, 1024) if adc_smem_bytes(m, 1, 1, 1) <= SMEM_OPTIN_BYTES)


def lut_stationary_smem_bytes(m: int, ms: int | None = None) -> int:
    """Dynamic shared memory of one LUT-stationary block (mirrors
    ``lutst::smem_bytes`` in ``csrc/pq_scan.cu``): ``ms`` subspaces of one
    query's LUT row (all ``m`` by default), each warp's ring of item stages
    (32 rows of codes, 16-byte padded, and their mask) and candidate buffer,
    and the block's range of slots with its runs."""
    ms = m if ms is None else ms
    stage = (_CHUNK * m + 15) // 16 * 16 + _CHUNK
    return (ms * NBOOK * 4 + _WARPS * _STAGES * stage + _WARPS * _SELECT_BUF * 8
            + _MAX_RANGE * 3 * 4 + (_MAX_RANGE + 1) * 4 + 16)


def lut_stationary_slice(m: int) -> int:
    """LUT subspaces a LUT-stationary block stages at once (mirrors
    ``lutst::lut_slice``): all ``m`` where the row fits beside the rings,
    else the widest multiple of 8 that does (the row then passes in slices,
    each row's sum carried in a register from one to the next); 0 where not
    even 8 fit."""
    if lut_stationary_smem_bytes(m) <= SMEM_OPTIN_BYTES:
        return m
    ms = (m - 1) // 8 * 8
    while ms > 0 and lut_stationary_smem_bytes(m, ms) > SMEM_OPTIN_BYTES:
        ms -= 8
    return ms


# widest M whose whole LUT row fits beside the rings (one slice); past it the
# row passes in slices, up to MAX_M like the dense layout's kernel
WHOLE_ROW_MAX_M = max(m for m in range(1, 1024) if lut_stationary_slice(m) == m)


def _check_k(k: int) -> None:
    if k > MAX_K:
        raise ValueError(f"k={k}: the ADC kernels take k <= {MAX_K} (with refine_factor, "
                         f"k' = refine_factor·k); use a smaller k or refine_factor, or an "
                         f"index on the CPU")


def check_pq_kernel_limits(k: int, m: int) -> None:
    """Raise ``ValueError`` for a problem ``adc_slot_warps_kernel`` (the dense
    layout's ``workunit_pq_scan``) cannot take: k above ``MAX_K`` (warp
    lists of 64), or M whose one LUT row and ring do not fit shared memory
    (the widest is ``MAX_M``). The plain versions, on the CPU, have neither
    limit."""
    _check_k(k)
    need = adc_smem_bytes(m, 1, 1, 1)
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(f"M={m}: the dense-layout ADC kernel's LUT row and ring need {need} "
                         f"bytes of shared memory, above {SMEM_OPTIN_BYTES} (the widest M "
                         f"is {MAX_M}); use an index on the CPU")


def check_lut_stationary_limits(k: int, m: int) -> None:
    """Raise ``ValueError`` for a problem the LUT-stationary kernels
    (``workunit_pq_scan_streamed``, ``pq_scan``) cannot take: k above
    ``MAX_K`` (warp lists of 64), or M above ``MAX_M`` (the dense layout's
    limit too; past ``WHOLE_ROW_MAX_M`` the LUT row is staged in slices)."""
    _check_k(k)
    if m > MAX_M:
        raise ValueError(f"M={m}: the LUT-stationary ADC kernels take M <= {MAX_M}, as the "
                         f"dense layout's; use an index on the CPU")


# --------------------------------------------------- the units kernel's work


def slot_order(lut_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The work list of ``workunit_pq_scan_streamed``: the W·TQ slots sorted
    by table row, stably. Returns (rows int32 [W·TQ] ascending, slot indices
    int64 [W·TQ], w·TQ + t); the -1 slots form one run, each row's slots
    keep their slot order. Runs on the tensor's device with no host copy."""
    return torch.sort(lut_idx.reshape(-1), stable=True)


def units_split(tv: int) -> tuple[int, int]:
    """(P, g) of the units kernel: a block takes P slots, a slot's 32-row
    chunks go to g warps. Up to 16 chunks (TV 512) a warp takes a slot and a
    block about 32 chunks a warp (P = 128 at TV 64, 16 at TV 512); longer
    units split over the block's 8 warps, P giving each about 16 chunks (P =
    4 at TV 1024, 1 at TV 4096), so a row that few slots share does not
    leave most warps waiting for the next."""
    chunks = -(-tv // _CHUNK)
    if chunks <= 16:
        return min(_MAX_RANGE, 256 // chunks), 1
    return max(1, 128 // chunks), _WARPS


def staged_lut_rows(rows: torch.Tensor, u: int, p: int) -> int:
    """LUT rows the units kernel stages for sorted rows ``rows`` (from
    ``slot_order``) and ``p`` slots a block: one per run of a real row
    inside each block's range (indices other than -1 clamped into ``[0,
    u)``, as the kernel does)."""
    r = torch.where(rows == -1, rows, rows.clamp(0, u - 1))
    pos = torch.arange(r.numel(), device=r.device)
    first = (pos % p == 0) | (r != torch.roll(r, 1))
    return int((first & (r != -1)).sum())


def launch_shape(w: int, tq: int, tv: int, m: int, k: int) -> tuple[int, ...]:
    """(G, g, T, Y, S, scratch words) of ``workunit_pq_scan``'s launch, from
    the C entry that picks it (``adc_launch_shape``): slots a block takes at
    a time, warps a slot, 32-row chunks a ring tile, blocks a unit over its
    slot groups and over its rows, and the int32 words of scratch the
    in-launch merge needs (0 when rows do not split)."""
    lib = _build.library("pq_scan")
    out = (ctypes.c_int * 6)()
    _build.check(lib, lib.adc_launch_shape(w, tq, tv, m, k, ctypes.cast(out, ctypes.c_void_p)),
                 "adc_launch_shape")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _on(dev: torch.device):
    """A launch's device guard, skipped when ``dev`` is already current (it
    costs host time on every call, and ``pq_scan`` is host-bound)."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def row_blocks(nv: int, sms: int) -> int:
    """Blocks of ``pq_scan``'s launch: about one per SM, fewer where a warp
    would get under two chunks of 32 rows."""
    chunks = -(-nv // _CHUNK)
    return max(1, min(sms, -(-chunks // (2 * _WARPS))))


# ------------------------------------------------------------ plain versions


def workunit_pq_scan_plain(luts, codes, valid, *, k: int, n_live=None):
    """Plain version of ``workunit_pq_scan``: ``ref.workunit_pq_topk_ref``,
    and ``(NEG_INF, -1)`` on the slots past ``n_live``."""
    workunit_pq_scan_plain.calls += 1
    s, i = _ref.workunit_pq_topk_ref(luts, codes, valid, int(k))
    return _ref.dead_slots_absent(s, i, n_live)


def workunit_pq_scan_streamed_plain(table, lut_idx, codes, valid, *, k: int):
    """Plain version of ``workunit_pq_scan_streamed``:
    ``ref.workunit_pq_topk_resident_ref`` (-1 slots are ``(NEG_INF, -1)``,
    any other index outside ``[0, U)`` raises)."""
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
    dev = tensors[0].device
    if any(t.device != dev for t in tensors[1:]):
        raise ValueError(f"tensors on different devices: {sorted({str(t.device) for t in tensors})}")


def _check_n_live(n_live, w: int, dev: torch.device) -> None:
    """Optional live-slot counts: int32 [W] on the inputs' device."""
    if n_live is not None and (n_live.dtype != torch.int32 or tuple(n_live.shape) != (w,)
                               or n_live.device != dev):
        raise ValueError(f"n_live must be int32 [W={w}] on {dev}, got {n_live.dtype} "
                         f"{tuple(n_live.shape)} on {n_live.device}")


def _check_launch(what: str, lut, *tensors) -> None:
    """CUDA tensors, contiguous, the LUTs on a 16-byte boundary."""
    if lut.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {lut.device}")
    if not all(t.is_contiguous() for t in (lut,) + tensors):
        raise ValueError(f"{what}: every input must be contiguous")
    if lut.data_ptr() % 16:
        raise ValueError(f"{what}: the LUTs must start on a 16-byte boundary")


# ------------------------------------------------------------------ wrappers


def workunit_pq_scan_streamed(
    table: torch.Tensor,  # f32 [U, M, 256] — resident per-query ADC tables
    lut_idx: torch.Tensor,  # i32 [W, TQ] — table row per unit slot (-1: no query)
    codes: torch.Tensor,  # uint8 [W, TV, M] — gathered code rows per unit
    valid: torch.Tensor,  # bool [W, TV]
    *,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Work-unit ADC scan reading each slot's LUT row from the resident
    table. Returns (scores f32 [W, TQ, k] best-first, idx i32 [W, TQ, k]).
    A slot of index -1 holds no query: it gives ``(NEG_INF, -1)`` and is
    never scored. Any other index outside ``[0, U)`` is a caller's error:
    the plain version raises, the kernel clamps it into the table."""
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
    TV, M = codes.shape[1], codes.shape[2]
    check_lut_stationary_limits(k, M)
    _check_launch("workunit_pq_scan_streamed", table, lut_idx, codes, valid)
    if table.shape[0] < 1:
        raise ValueError("workunit_pq_scan_streamed: the table has no row")
    rows, order = slot_order(lut_idx)
    out_s = torch.empty((W, TQ, k), dtype=torch.float32, device=codes.device)
    out_i = torch.empty((W, TQ, k), dtype=torch.int32, device=codes.device)
    lib = _build.library("pq_scan")
    with _on(codes.device):
        rc = lib.lut_stationary_units_launch(
            table.data_ptr(), rows.data_ptr(), order.data_ptr(), codes.data_ptr(), valid.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), W, TQ, TV, M, table.shape[0], k, *units_split(TV),
            torch.cuda.current_stream(codes.device).cuda_stream,
        )
    _build.check(lib, rc, "workunit_pq_scan_streamed")
    workunit_pq_scan_streamed.launches += 1
    return out_s, out_i


workunit_pq_scan_streamed.launches = 0


def workunit_pq_scan(
    luts: torch.Tensor,  # f32 [W, TQ, M, 256] — per-query ADC tables per unit
    codes: torch.Tensor,  # uint8 [W, TV, M]
    valid: torch.Tensor,  # bool [W, TV]
    *,
    k: int,
    n_live: torch.Tensor | None = None,  # i32 [W]: real query slots per unit (None: all)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Work-unit ADC scan over expanded LUTs. Returns (scores f32
    [W, TQ, k] best-first, idx i32 [W, TQ, k]). Slot s of unit w holds a
    query iff s < ``n_live[w]``; the others are ``(NEG_INF, -1)`` and their
    LUTs are never read."""
    k = int(k)
    if luts.dim() != 4 or codes.dim() != 3:
        raise ValueError(f"want luts [W,TQ,M,256], codes [W,TV,M]; got "
                         f"{tuple(luts.shape)}, {tuple(codes.shape)}")
    _check_lut(luts, tuple(luts.shape[:2]))
    if codes.shape[0] != luts.shape[0]:
        raise ValueError(f"codes {tuple(codes.shape)} for luts {tuple(luts.shape)}")
    _check_codes(codes, valid, luts.shape[2], k)
    _same_device(luts, codes, valid)
    W, TQ = luts.shape[:2]
    _check_n_live(n_live, W, codes.device)
    if codes.device.type == "cpu":
        return workunit_pq_scan_plain(luts, codes, valid, k=k, n_live=n_live)
    TV, M = codes.shape[1], codes.shape[2]
    check_pq_kernel_limits(k, M)
    _check_launch("workunit_pq_scan", luts, codes, valid, *(() if n_live is None else (n_live,)))
    dev = codes.device
    out = torch.empty((2, W, TQ, k), dtype=torch.int32, device=dev)  # scores' bits, then ids
    out_s, out_i = out[0].view(torch.float32), out[1]
    if out.numel() == 0:
        return out_s, out_i
    words = launch_shape(W, TQ, TV, M, k)[5]
    # where rows split over blocks: the ranges' lists and a counter per (unit, slot group)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev) if words else None
    lib = _build.library("pq_scan")
    with _on(dev):
        rc = lib.adc_scan_launch(
            luts.data_ptr(), codes.data_ptr(), valid.data_ptr(),
            0 if n_live is None else n_live.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), W, TQ, TV, M, k, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "workunit_pq_scan")
    workunit_pq_scan.launches += 1
    return out_s, out_i


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
    nv, M = codes.shape
    check_lut_stationary_limits(k, M)
    _check_launch("pq_scan", lut, codes, valid)
    dev = codes.device
    G = row_blocks(nv, _sm_count(dev.index))
    # one allocation (int32 words): the output's scores and ids, the blocks'
    # lists (scores, then ids), and the counter, which the launch entry
    # zeroes on the stream just before the kernel
    buf = torch.empty((2 * (G + 1) * k + 1,), dtype=torch.int32, device=dev)
    out_s, out_i = buf[:k].view(torch.float32), buf[k:2 * k]
    base = buf.data_ptr()
    lib = _build.library("pq_scan")
    with _on(dev):
        rc = lib.lut_stationary_rows_launch(
            lut.data_ptr(), codes.data_ptr(), valid.data_ptr(), base + 8 * k, base + 8 * k + 4 * G * k,
            base + 8 * (G + 1) * k, base, base + 4 * k, nv, M, k, G, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, rc, "pq_scan")
    pq_scan.launches += 1
    return out_s, out_i


pq_scan.launches = 0
