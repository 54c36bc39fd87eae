"""Distributed batch hybrid search: the plan/execute engine on a device mesh.

The counterpart of ``repro.core.distributed``. Mapping of HQI onto the
(data, model) mesh (``launch/mesh.py``):

  * the ``PackedArena`` is sharded over the **model** axis as contiguous
    posting-list slices (``PackedArena.shard``): rank r's f32 rows, uint8 PQ
    codes and id map live on the rank's device;
  * the plan is replicated: ``build_plan_sharded`` routes every engine task's
    work units to their posting list's owner rank, and each bucket runs as
    one sharded dispatch (``ops.sharded_workunit_topk`` /
    ``sharded_workunit_pq_topk``); bitmap pushdown and PQ compose unchanged;
  * the only cross-rank traffic is the per-query top-k candidate gather of
    ``ops.sharded_merge_topk`` — O(k · |model|) (score, id) pairs per query,
    independent of DB size, never distance rows;
  * every other axis (data, pod) replicates: the query stream splits over
    those at the serving layer, so the engine computes once, on the devices
    at index 0 of those axes (``ShardSpec.rank_devices``).

Like the reference's ``shard_map``, the engine is single-controller: one
process drives every rank; ranks may share a device (the tests' CPU, one
card). ``execute_sharded`` is the whole entry point: ``HQIIndex.search``
routes through it when ``HQIConfig.mesh`` is set, and
``batch_search_ivf(mesh=...)`` uses it for standalone indexes. Results are
bit-identical to the single-device engine (tests/test_torch_sharded.py).

``make_roofline_search_step`` is the dry run's model of the sharded
engine's device program at 100M-vector scale (the host-side planner
abstracted to a resident full scan): a roofline row, not a search API. It
runs on a CPU mesh (the plain versions), a card mesh (the scan kernel) and
a ``meta`` mesh (shapes only, charged to ``launch.op_cost``'s counter).
``roofline_search_specs`` gives its inputs as meta tensors with their axis
tuples.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..obs.trace import get_tracer
from .arena import ShardedArena
from .ivf import ScanStats
from .plan import EngineTask, PlanConfig, build_plan_sharded
from .planner import ExtraCandidates, ShardStats, execute_plan_sharded


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Which mesh axis the engine shards the arena over.

    Only ``model_axis`` is read: every other mesh axis (data, pod)
    replicates — the query stream splits over those host-side at the
    serving layer, where each group runs its slice of the workload through
    this engine independently.
    """

    model_axis: str = "model"

    def n_shards(self, mesh) -> int:
        return int(mesh.shape[self.model_axis])

    def rank_devices(self, mesh) -> List[torch.device]:
        """Rank r's device: the mesh's r-th along the model axis, at index 0
        of every other axis."""
        return mesh.axis_devices(self.model_axis)


def execute_sharded(
    sharded: ShardedArena,
    tasks: List[EngineTask],
    q_vecs: np.ndarray,  # f32 [m, d]
    *,
    mesh,
    spec: Optional[ShardSpec] = None,
    m: int,
    k: int,
    cfg: Optional[PlanConfig] = None,
    extra: Sequence[ExtraCandidates] = (),
    stats: Optional[ScanStats] = None,
) -> Tuple[np.ndarray, np.ndarray, ShardStats]:
    """Plan + execute one workload's vector work across the mesh.

    Replicates the plan (``build_plan_sharded`` routes tasks to arena-shard
    owners), executes with per-rank bucket dispatches and the gather top-k
    merge. Returns (scores f32 [m, k], ids i64 [m, k], per-rank
    ``ShardStats``) — scores/ids bit-identical to the single-device
    ``build_plan``/``execute_plan`` pair.
    """
    spec = ShardSpec() if spec is None else spec
    cfg = PlanConfig() if cfg is None else cfg
    assert sharded.n_shards == spec.n_shards(mesh), (
        f"arena sharded {sharded.n_shards} ways but mesh axis "
        f"{spec.model_axis!r} has {spec.n_shards(mesh)} ranks"
    )
    assert list(sharded.devices) == spec.rank_devices(mesh), (
        f"arena shards on {sharded.devices}, mesh ranks on {spec.rank_devices(mesh)}"
    )
    with get_tracer().span("plan.build", mode="sharded", tasks=len(tasks)):
        splan = build_plan_sharded(sharded, tasks, q_vecs, m=m, k=k, cfg=cfg, stats=stats)
    shard_stats = ShardStats.zeros(sharded.n_shards)
    scores, ids = execute_plan_sharded(
        splan, sharded, q_vecs,
        mesh=mesh, axis=spec.model_axis, cfg=cfg,
        extra=extra, stats=stats, shard_stats=shard_stats,
    )
    return scores, ids, shard_stats


# ----------------------------------------------------------- dry-run roofline


def make_roofline_search_step(mesh, *, k: int, metric: str = "ip"):
    """(db, bitmap, queries) -> (scores f32 [m, k], ids i64 [m, k]): the dry
    run's model of the sharded engine's device program at production scale.

    Single-controller over ``mesh``, as the sharded engine: for each index
    along the batch axes (``_batch_axes``) the queries' slice meets every
    model rank, and rank r scans its contiguous row shard (``n / |model|``
    rows of db and bitmap) as one work unit of the port's scan
    (``ops._unit_scan``: ``fused_knn_db_stationary`` where TV ≥ 4·TQ),
    its hits made global as ``idx + r · n_local``. The ranks' top-k then go
    through ``ops.sharded_merge_topk``, the real engine's merge (the
    k·|model| candidate gather, ``lax.top_k``'s tie rule, ``(-inf, -1)``
    where absent). Ranks that share a device are one launch over their
    units, their rows a view of ``db`` where it lives on that device (a
    copy otherwise). Results come back on the first rank's device.

    The reference's ``db_tile`` has no counterpart: the reference scans
    in row tiles only so that the M×N score matrix never exists, and the
    port's kernel never builds that matrix. On a CPU mesh the plain versions run,
    on a card mesh the kernels (no fallback), on a meta mesh shapes only
    (the kernels charge ``launch.op_cost``'s counter). A roofline row
    ("hqi-search"), not a search API: real searches go through
    ``execute_sharded``.
    """
    baxes = _batch_axes(mesh)
    n_model = int(mesh.shape["model"])
    n_batch = int(np.prod([mesh.shape[a] for a in baxes])) if baxes else 1
    rank_devices = mesh.axis_devices("model")

    def step(db: torch.Tensor, bitmap: torch.Tensor, queries: torch.Tensor):
        n, d = db.shape
        m = queries.shape[0]
        if n % n_model or m % n_batch:
            raise ValueError(f"db rows {n} and queries {m} must divide over model {n_model} and batch {n_batch}")
        n_local, mq = n // n_model, m // n_batch
        out_s, out_i = [], []
        for b in range(n_batch):
            qb = queries[b * mq:(b + 1) * mq]
            per_rank = [None] * n_model
            for dev, ranks in _ranks_by_device(rank_devices).items():
                r0, r1 = ranks[0], ranks[-1] + 1
                v = db[r0 * n_local:r1 * n_local].to(dev).view(r1 - r0, n_local, d)
                valid = bitmap[r0 * n_local:r1 * n_local].to(dev).view(r1 - r0, n_local)
                q = qb.to(dev)[None].expand(r1 - r0, mq, d).contiguous()
                s, i = ops._unit_scan(q, v, valid, k, metric, None)
                for j, r in enumerate(range(r0, r1)):
                    gi = i[j].to(torch.int64)
                    per_rank[r] = (s[j], torch.where(gi >= 0, gi + r * n_local, -1))
            top_s, top_i = ops.sharded_merge_topk(
                mesh, "model", [p[0] for p in per_rank], [p[1] for p in per_rank], k)
            out_s.append(top_s)
            out_i.append(top_i)
        if n_batch == 1:
            return out_s[0], out_i[0]
        return torch.cat(out_s), torch.cat(out_i)

    return step


def _ranks_by_device(rank_devices) -> dict:
    """device -> the model ranks on it, which must be contiguous (each
    device's rows are then one view of ``db``)."""
    out: dict = {}
    for r, dev in enumerate(rank_devices):
        out.setdefault(dev, []).append(r)
    for dev, ranks in out.items():
        if ranks != list(range(ranks[0], ranks[-1] + 1)):
            raise ValueError(f"model ranks {ranks} on {dev} are not contiguous")
    return out


def _batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def roofline_search_specs(mesh, *, n: int, d: int, m: int):
    """The dry run's inputs as ``meta`` tensors of the global shapes — db
    f32 [n, d], bitmap bool [n], queries f32 [m, d] — and beside them their
    axis tuples in the port's sharding convention (``distributed/
    sharding.py``): ``(("model", None), ("model",), (batch axes, None))``."""
    baxes = _batch_axes(mesh)
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    tensors = (meta((n, d), torch.float32), meta((n,), torch.bool), meta((m, d), torch.float32))
    return tensors, (("model", None), ("model",), (baxes or None, None))
