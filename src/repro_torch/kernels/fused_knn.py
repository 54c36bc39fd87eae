"""Fused masked similarity + top-k over a batch of work units (the HQI hot loop).

Two wrappers over the CUDA scan of ``csrc/fused_knn.cu``:

  * ``fused_knn`` — query-stationary: one block per (work unit, chunk of 64
    query slots) scans all of the unit's rows;
  * ``fused_knn_db_stationary`` — split rows: ``split_count(W, TQ, TV)``
    blocks per (unit, query chunk) each scan a range of rows, and the last
    of them to finish merges their partial lists in the same launch. The TPU
    grid of the same name reads each DB tile from HBM once; on Hopper the
    point is to spread a long unit over many SMs.

Both take the work-unit batch ``q [W, TQ, D]``, ``v [W, TV, D]`` (f32 or
bf16), ``valid bool [W, TV]`` and optional ``n_live int32 [W]`` (slot s of
unit w holds a query iff s < n_live[w]; ``None``: every slot), and return
``(f32 [W, TQ, k], i32 [W, TQ, k])``: scores best-first under (score desc,
row asc), row indices local to the unit, ``(NEG_INF, -1)`` where no valid
row fills a slot and on every slot that holds no query. A CUDA tensor
launches the kernel (or the wrapper raises); a CPU tensor takes the plain
version, ``fused_knn_plain``. ``launches`` on each wrapper counts kernel
launches. The kernels' lists hold ``MAX_K`` entries; a larger k is taken in
``floor_passes``, one launch a pass.
"""
from __future__ import annotations

import torch

from . import _build
from . import ref as _ref

MAX_K = 64  # largest k one launch's lists hold: a larger k takes passes (floor_passes)
SMEM_OPTIN_BYTES = 227 * 1024  # sm_90: most dynamic shared memory a block may opt into
# kQB, kTR, kDC, kPass, kMinRangeTiles and kSplitTarget of csrc/fused_knn.cu:
# query slots a block takes, rows a tile, elements of D a chunk, rows a
# compaction pass, tiles a split range holds at least, blocks the split grid
# aims for (4 on each of 132 SMs)
_QB, _TR, _DC, _PASS, _MIN_RANGE_TILES, _SPLIT_TARGET = 64, 32, 64, 256, 8, 4 * 132


def split_count(w: int, tq: int, tv: int) -> int:
    """Row ranges per (unit, query chunk) of the split grid (mirrors
    ``split_of`` in ``csrc/fused_knn.cu``): enough that the grid reaches
    ``_SPLIT_TARGET`` blocks, each range at least ``_MIN_RANGE_TILES``
    whole tiles; 1 for units of one query slot (a warp per unit)."""
    if tq == 1:
        return 1
    base = w * -(-tq // _QB)
    tiles = -(-tv // _TR)
    s = min(-(-_SPLIT_TARGET // base), tiles // _MIN_RANGE_TILES)
    if s <= 1:
        return 1
    chunk_rows = -(-tiles // s) * _TR
    return -(-tv // chunk_rows)


def scan_smem_bytes(d: int, k: int, elem_size: int = 4) -> int:
    """Dynamic shared memory of one scan block (mirrors ``scan_smem_bytes``
    in ``csrc/fused_knn.cu``): the live queries (one copy per ring stage
    when D spans more than one 64-element chunk), a two-stage ring of
    32-row tiles, a tile's candidate keys, two copies of the 64 slots'
    k-entry lists, a pass's row indices, the norms and a few counters. Rows
    are staged a chunk at a time, so it does not grow with d past 64."""
    row = _DC * elem_size + 16
    nch = -(-d // _DC)
    return ((2 if nch > 1 else 1) * _QB * row + 2 * _TR * row + _QB * (_TR + 1) * 8
            + 2 * _QB * k * 8 + _PASS * 4 + (_QB + _TR) * 4 + (_QB + 16) * 4)


def kernel_passes(k: int) -> int:
    """Launches a scan kernel makes for a list of k: one per ``MAX_K``."""
    return -(-int(k) // MAX_K)


def floor_passes(k: int, run):
    """A top-k list longer than the kernels' ``MAX_K`` as passes of at most
    ``MAX_K`` entries. ``run(kp, floor)`` launches one pass of ``kp``
    entries and returns its ``(scores f32 [..., kp], ids i32 [..., kp])``;
    ``floor`` is None for the first pass, else ``(floor_s f32 [...],
    floor_i i32 [...])``, the last entry of the pass before, past which the
    kernel admits candidates (strictly after it under (score desc, index
    asc)). A slot that pass left short has floor index -1: it is done, and
    the kernel writes ``(NEG_INF, -1)`` there. Ranks are a strict total
    order, so the passes laid end to end along k are exactly the top-k, ties
    included. Returns ``(scores [..., k], ids [..., k])``."""
    if k <= MAX_K:
        return run(k, None)
    parts_s, parts_i, floor = [], [], None
    for k0 in range(0, k, MAX_K):
        s, i = run(min(MAX_K, k - k0), floor)
        parts_s.append(s)
        parts_i.append(i)
        floor = (s[..., -1].contiguous(), i[..., -1].contiguous())
    return torch.cat(parts_s, dim=-1), torch.cat(parts_i, dim=-1)


def live_after(floor_i: torch.Tensor) -> torch.Tensor:
    """``n_live`` of a later pass (i32 [W]) from its floor ids [W, TQ]: one
    past the last slot the pass before did not leave short (slots past
    ``n_live`` are short too: they hold (NEG_INF, -1)), so the kernel reads
    nothing for the units that are done."""
    pos = torch.arange(1, floor_i.shape[1] + 1, dtype=torch.int32, device=floor_i.device)
    return torch.where(floor_i >= 0, pos, 0).amax(dim=1).to(torch.int32)


def fused_knn_plain(
    q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, *, k: int, metric: str = "ip",
    n_live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of both grids: ``masked_topk_ref``'s masked top-k over
    every unit, its scores summed in the kernels' order
    (``ref.kernel_order_scores``, bit-equal to them), and ``(NEG_INF, -1)``
    on the slots past ``n_live``. Only the pairs of a live slot and a valid
    row are scored (the others are masked or dropped either way), in chunks
    of ``_PLAIN_PAIRS``: the kernels' order costs a loop over D in fp64."""
    fused_knn_plain.calls += 1
    W, TQ, _ = q.shape
    live = torch.ones((W, TQ), dtype=torch.bool, device=q.device)
    if n_live is not None:
        live = torch.arange(TQ, device=q.device)[None, :] < n_live.to(q.device)[:, None]
    w, t, r = torch.nonzero(live[:, :, None] & valid[:, None, :], as_tuple=True)
    scores = torch.full((W, TQ, v.shape[1]), _ref.NEG_INF, dtype=torch.float32, device=q.device)
    if metric == "l2":
        qn, vn = _ref.fmaf_chain(q, q), _ref.fmaf_chain(v, v)
    for a in range(0, w.numel(), _PLAIN_PAIRS):
        wc, tc, rc = w[a:a + _PLAIN_PAIRS], t[a:a + _PLAIN_PAIRS], r[a:a + _PLAIN_PAIRS]
        sc = _ref.fmaf_chain(q[wc, tc], v[wc, rc])
        if metric == "l2":
            sc = (2.0 * sc - qn[wc, tc]) - vn[wc, rc]
        scores[wc, tc, rc] = sc
    s, i = _ref.masked_topk_of_scores(scores, valid, int(k))
    return _ref.dead_slots_absent(s, i, n_live)


_PLAIN_PAIRS = 1 << 20  # (slot, row) pairs the plain version scores at once


fused_knn_plain.calls = 0


def _check(q, v, valid, k: int, metric: str, n_live) -> None:
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
    if n_live is not None:
        if n_live.dtype != torch.int32 or tuple(n_live.shape) != (W,) or n_live.device != q.device:
            raise ValueError(f"n_live must be int32 [W={W}] on {q.device}, got {n_live.dtype} "
                             f"{tuple(n_live.shape)} on {n_live.device}")


def _launch(wrapper, entry: str, q, v, valid, k: int, metric: str, n_live):
    """Check what the kernels take, then launch ``entry`` once for each of
    ``floor_passes``' passes (``_passes``)."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_knn runs on cuda or cpu tensors, got {q.device}")
    tensors = (q, v, valid) if n_live is None else (q, v, valid, n_live)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, v, valid and n_live must be contiguous")
    return _passes(wrapper, entry, q, v, valid, k, metric, n_live)


def _passes(wrapper, entry: str, q, v, valid, k: int, metric: str, n_live):
    """``floor_passes`` of ``entry``: a later pass reads only the units whose
    slots the pass before did not leave short (``live_after``)."""
    def run(kp, floor):
        live = n_live if floor is None else live_after(floor[1])
        return _launch_pass(wrapper, entry, q, v, valid, kp, metric, live, floor)

    return floor_passes(k, run)


def _launch_pass(wrapper, entry: str, q, v, valid, k: int, metric: str, n_live, floor):
    """Allocate one pass's outputs (and the split grid's scratch), launch
    ``entry`` on the current stream and count the launch on ``wrapper``."""
    W, TQ, D = q.shape
    TV = v.shape[1]
    out_s = torch.empty((W, TQ, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((W, TQ, k), dtype=torch.int32, device=q.device)
    if out_s.numel() == 0:
        return out_s, out_i
    shape = (W, TQ, TV, D, k, int(metric == "l2"), int(q.dtype == torch.bfloat16))
    head = (q.data_ptr(), v.data_ptr(), valid.data_ptr(), 0 if n_live is None else n_live.data_ptr(),
            0 if floor is None else floor[0].data_ptr(), 0 if floor is None else floor[1].data_ptr())
    lib = _build.library("fused_knn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if entry == "fused_knn_launch":
            rc = lib.fused_knn_launch(*head, out_s.data_ptr(), out_i.data_ptr(), *shape, stream)
        else:
            S = split_count(W, TQ, TV)
            scratch = (0, 0)
            if S > 1:  # partial lists as 64-bit rank keys, and a counter per (unit, query chunk)
                part = torch.empty((W, S, TQ, k), dtype=torch.int64, device=q.device)
                counters = torch.empty((W * -(-TQ // _QB),), dtype=torch.int32, device=q.device)
                scratch = (part.data_ptr(), counters.data_ptr())
            rc = lib.fused_knn_db_stationary_launch(*head, *scratch, out_s.data_ptr(),
                                                    out_i.data_ptr(), *shape, S, stream)
    _build.check(lib, rc, wrapper.__name__)
    wrapper.launches += 1
    return out_s, out_i


def fused_knn(
    q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, *, k: int, metric: str = "ip",
    n_live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Query-stationary grid. See the module docstring for the contract."""
    k = int(k)
    _check(q, v, valid, k, metric, n_live)
    if q.device.type == "cpu":
        return fused_knn_plain(q, v, valid, k=k, metric=metric, n_live=n_live)
    return _launch(fused_knn, "fused_knn_launch", q, v, valid, k, metric, n_live)


fused_knn.launches = 0


def fused_knn_db_stationary(
    q: torch.Tensor, v: torch.Tensor, valid: torch.Tensor, *, k: int, metric: str = "ip",
    n_live: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Split-row grid: ``split_count`` blocks per (unit, query chunk), their
    partial lists merged by the last of them, one launch."""
    k = int(k)
    _check(q, v, valid, k, metric, n_live)
    if q.device.type == "cpu":
        return fused_knn_plain(q, v, valid, k=k, metric=metric, n_live=n_live)
    return _launch(fused_knn_db_stationary, "fused_knn_db_stationary_launch", q, v, valid, k,
                   metric, n_live)


fused_knn_db_stationary.launches = 0
