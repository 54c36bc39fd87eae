"""HQI core on PyTorch — the counterpart of ``repro.core``.

Public API:
    VectorDatabase, Column, Workload, HybridQuery, SearchResult
    predicates: Cmp, Between, In, Contains, NotNull, CentroidIn, make_filter
    HQIIndex / HQIConfig / Router — workload-aware index + Algorithm-3 search
    engine: PackedArena, PlanConfig, EngineTask, ExecutionPlan,
            build_plan / execute_plan, batch_search_ivf
    compression: PQCodebook / PQIndex, train_pq / encode_pq / adc_tables
            (engine integration via PlanConfig.scan_mode="pq")
    baselines: exhaustive_search, PreFilterIndex, PostFilterIndex, RangeIndex
    metrics: recall_at_k, tune_nprobe
"""
from .types import (  # noqa: F401
    Column,
    HybridQuery,
    METRIC_IP,
    METRIC_L2,
    SearchResult,
    VectorDatabase,
    Workload,
)
from .predicates import (  # noqa: F401
    Between,
    CentroidIn,
    Cmp,
    Contains,
    In,
    NotNull,
    evaluate_filter,
    make_filter,
)
from .qdtree import QDTree, build_qdtree  # noqa: F401
from .ivf import IVFIndex, ScanStats  # noqa: F401
from .pq import PQCodebook, PQIndex, adc_tables, encode_pq, train_pq  # noqa: F401
from .arena import PackedArena  # noqa: F401
from .plan import EngineTask, ExecutionPlan, PlanConfig, build_plan  # noqa: F401
from .planner import batch_search_ivf, execute_plan  # noqa: F401
from .hqi import HQIConfig, HQIIndex, Router  # noqa: F401
from .baselines import (  # noqa: F401
    PostFilterIndex,
    PreFilterIndex,
    RangeIndex,
    exhaustive_search,
)
from .metrics import per_template_recall, recall_at_k, tune_nprobe  # noqa: F401
from .workload import kg_style, lp_style, synthetic_bigann_style  # noqa: F401
