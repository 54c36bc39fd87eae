"""Fused masked similarity + top-k over a batch of work units (the HQI hot loop).

Two wrappers over the CUDA kernels of ``csrc/fused_knn.cu``:

  * ``fused_knn`` — query-stationary: one block per (work unit, query chunk)
    sweeps the unit's rows with a running top-k;
  * ``fused_knn_db_stationary`` — split-V: the unit's rows are cut into
    ``SPLIT_ROWS``-row chunks, each chunk scored by its own block into a
    partial top-k, and a second kernel merges the partials. The TPU grid of
    the same name reads each DB tile from HBM once; on Hopper the point is to
    spread a long unit over many SMs.

Both take the work-unit batch ``q [W, TQ, D]``, ``v [W, TV, D]`` (f32 or
bf16), ``valid bool [W, TV]`` and return ``(f32 [W, TQ, k], i32 [W, TQ, k])``:
scores best-first under (score desc, row asc), row indices local to the unit,
``(NEG_INF, -1)`` where no valid row fills a slot. A CUDA tensor launches the
kernel (or the wrapper raises); a CPU tensor takes the plain version,
``fused_knn_plain``. ``launches`` on each wrapper counts kernel launches.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

SPLIT_ROWS = 256  # rows per block of the split-V grid
MAX_K = 64  # largest k the kernels' register lists hold
SMEM_OPTIN_BYTES = 227 * 1024  # sm_90: most dynamic shared memory a block may opt into
_THREADS, _TILE_ROWS = 256, 64  # kThreads, kTileRows of csrc/fused_knn.cu


def scan_smem_bytes(tq: int, d: int, k: int) -> int:
    """Dynamic shared memory of one scan block (mirrors ``scan_smem_bytes`` in
    ``csrc/fused_knn.cu``): the block's query chunk and a row tile at an odd
    row stride, or the row lanes' top-K lists, whichever is larger."""
    qb = 1
    while qb < tq and qb < 64:
        qb <<= 1
    kb = next(b for b in (8, 16, 32, 64) if k <= b)
    tile = (qb + _TILE_ROWS) * (d | 1) * 4 + _TILE_ROWS * 4 + _TILE_ROWS
    return max(tile, _THREADS * kb * 8)


def check_kernel_limits(k: int, d: int, tq: int) -> None:
    """Raise ``ValueError`` for a problem the CUDA kernels cannot take: k above
    ``MAX_K``, or a width whose tiles overflow shared memory (d above 453 with
    the engine's 64-query units). The plain version, on the CPU, has neither
    limit."""
    if k > MAX_K:
        raise ValueError(f"k={k}: the CUDA kernels take k <= {MAX_K}; use a smaller k "
                         f"or an index on the CPU")
    need = scan_smem_bytes(tq, d, k)
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(f"d={d}: the CUDA kernels' tiles need {need} bytes of shared "
                         f"memory at {tq} queries per unit, above {SMEM_OPTIN_BYTES}; "
                         f"use an index on the CPU")


def fused_knn_plain(
    q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, *, k: int, metric: str = "ip"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of both grids: ``masked_topk_ref`` over every unit."""
    fused_knn_plain.calls += 1
    return _ref.masked_topk_ref(q, v, valid, int(k), metric)


fused_knn_plain.calls = 0


def _check(q, v, valid, k: int, metric: str) -> None:
    if q.dim() != 3 or v.dim() != 3 or valid.dim() != 2:
        raise ValueError(f"want q [W,TQ,D], v [W,TV,D], valid [W,TV]; got "
                         f"{tuple(q.shape)}, {tuple(v.shape)}, {tuple(valid.shape)}")
    W, _, D = q.shape
    if v.shape[0] != W or v.shape[2] != D or tuple(valid.shape) != (W, v.shape[1]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, v {tuple(v.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if q.dtype != v.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q and v must both be float32 or bfloat16, got {q.dtype}, {v.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if not (q.device == v.device == valid.device):
        raise ValueError(f"tensors on different devices: {q.device}, {v.device}, {valid.device}")
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if not 1 <= k <= v.shape[1]:
        raise ValueError(f"k={k} outside [1, TV={v.shape[1]}]")


def _cuda_args(q, v, valid, k: int):
    if q.device.type != "cuda":
        raise ValueError(f"fused_knn runs on cuda or cpu tensors, got {q.device}")
    W, TQ, D = q.shape
    check_kernel_limits(k, D, TQ)
    if not (q.is_contiguous() and v.is_contiguous() and valid.is_contiguous()):
        raise ValueError("q, v and valid must be contiguous")
    out_s = torch.empty((W, TQ, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((W, TQ, k), dtype=torch.int32, device=q.device)
    return W, TQ, v.shape[1], D, out_s, out_i


def fused_knn(
    q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, *, k: int, metric: str = "ip"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Query-stationary grid. See the module docstring for the contract."""
    k = int(k)
    _check(q, v, valid, k, metric)
    if q.device.type == "cpu":
        return fused_knn_plain(q, v, valid, k=k, metric=metric)
    W, TQ, TV, D, out_s, out_i = _cuda_args(q, v, valid, k)
    if out_s.numel() == 0:
        return out_s, out_i
    lib = _build.library("fused_knn")
    with torch.cuda.device(q.device):
        rc = lib.fused_knn_launch(
            q.data_ptr(), v.data_ptr(), valid.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            W, TQ, TV, D, k, int(metric == "l2"), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "fused_knn")
    fused_knn.launches += 1
    return out_s, out_i


fused_knn.launches = 0


def fused_knn_db_stationary(
    q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, *, k: int, metric: str = "ip"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-V grid (partial top-k per ``SPLIT_ROWS`` rows, then a merge)."""
    k = int(k)
    _check(q, v, valid, k, metric)
    if q.device.type == "cpu":
        return fused_knn_plain(q, v, valid, k=k, metric=metric)
    W, TQ, TV, D, out_s, out_i = _cuda_args(q, v, valid, k)
    if out_s.numel() == 0:
        return out_s, out_i
    S = -(-TV // SPLIT_ROWS)
    part_s = torch.empty((W, S, TQ, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((W, S, TQ, k), dtype=torch.int32, device=q.device)
    lib = _build.library("fused_knn")
    with torch.cuda.device(q.device):
        rc = lib.fused_knn_db_stationary_launch(
            q.data_ptr(), v.data_ptr(), valid.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(),
            W, TQ, TV, D, k, int(metric == "l2"), int(q.dtype == torch.bfloat16), SPLIT_ROWS,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, rc, "fused_knn_db_stationary")
    fused_knn_db_stationary.launches += 1
    return out_s, out_i


fused_knn_db_stationary.launches = 0
