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

The reference's dry-run program (``make_roofline_search_step``,
``roofline_search_specs``) waits with the LM scaffolding's dry run
(ROADMAP.md §1, the rest of the LM scaffolding).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

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
