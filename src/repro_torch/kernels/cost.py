"""What a kernel wrapper charges when it is given ``meta`` tensors.

The dry run (``launch/dryrun.py``) runs a whole step on ``meta`` tensors
under ``launch.op_cost.OpCounter``, which counts every aten op the step
issues. A kernel launch is not an aten op, so each wrapper has a branch
for ``device.type == "meta"``: it launches nothing, returns empty outputs
of the right shapes and dtypes, and calls ``charge`` with the kernel's
FLOPs and the operands it reads and the outputs it writes. The branch is
reached only from a meta tensor; a CUDA tensor launches and a CPU tensor
takes the plain version, as before.

With no counter active, a charge is dropped.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

_ACTIVE: List = []  # the counters entered, innermost last


def charge(kernel: str, flops: float, dtype: torch.dtype,
           reads: Sequence[torch.Tensor], writes: Sequence[torch.Tensor]) -> None:
    """Charge the innermost active counter: ``flops`` at ``dtype``'s rate,
    each tensor of ``reads`` read once and each of ``writes`` written once
    (a tensor listed twice is read twice)."""
    if _ACTIVE:
        _ACTIVE[-1].charge_kernel(kernel, float(flops), dtype, tuple(reads), tuple(writes))
