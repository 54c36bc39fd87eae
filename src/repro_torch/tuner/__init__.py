"""Index-evolution tuner: drift-triggered re-partitioning with hot swap.

See ``tuner.Tuner`` — the control loop that closes the paper's workload-
awareness story: the qd-tree/IVF layout follows the *live* workload instead
of staying frozen at build time.
"""
from .tuner import SwapRecord, Tuner, TunerConfig

__all__ = ["SwapRecord", "Tuner", "TunerConfig"]
