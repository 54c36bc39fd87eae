"""Op-level cost of a step run eagerly on ``meta`` tensors — the counterpart
of ``repro.launch.hlo_cost``.

The reference lowers each step to XLA on 512 placeholder host devices and
walks the compiled per-device HLO text. PyTorch has neither an SPMD
partitioner nor a compiled program to read, so the port counts the same
three roofline inputs from the ops a step issues:

  * **FLOPs** — ``OpCounter`` is a ``TorchDispatchMode``: every aten op the
    step issues passes through it, and an op that
    ``torch.utils.flop_counter`` has a formula for (the matmul family,
    convolutions, attention) is charged by that formula; an op it has none
    for is decomposed when it can be, as ``FlopCounterMode`` does. A kernel
    launch is not an aten op: on meta tensors each kernel wrapper charges
    its own count through ``kernels.cost.charge`` (the scans 2·TQ·TV·D a
    unit; attention 4·dh a kept pair and query head forward, 10·dh
    backward). FLOPs are kept apart by the type of the op's first operand
    (``bf16`` for bf16 and f16, ``f32`` for the rest), so that the compute
    term divides each share by its own peak (``roofline.RooflineTerms``).
    Like the reference's dot count, elementwise work is not counted.
  * **HBM bytes** — eager PyTorch fuses nothing, so every op that is not a
    view reads each tensor operand once and writes each output once. Views,
    ``empty`` and the other allocators cost 0; so do reshapes of contiguous
    tensors (``reshape`` is a view there, and a copy, counted, otherwise).
    An operand broadcast by a zero stride is read once, not once a use. An
    op that only writes (``copy_``, ``fill_``, ``zero_``) does not read the
    tensor it writes; an indexing op touches only the rows it indexes (a
    gather reads its output's size of its source, an in-place scatter such
    as a KV-cache write writes its values' size of its destination).
  * **The peak of live bytes** — every storage an op creates counts from its
    creation until it is freed (``weakref.finalize`` on the storage);
    ``peak_bytes`` is the largest sum seen. Storages that existed before the
    counter was entered (parameters, optimizer state, caches, inputs) are
    arguments, not temporaries, and are never counted here.

**Loops.** The step runs eagerly, so a Python loop over layers or
microbatches issues its ops once an iteration and each is counted as it
runs: the reference's trip-count machinery (``while`` bodies weighted by
their loop bounds) has no counterpart. The same holds for
``torch.utils.checkpoint``: the recomputed forward runs inside the backward
and is counted there, as the reference's remat shows in its HLO.

**Per device.** One controller runs the whole step at its global shapes,
so a per-device figure is derived from the global count:

  * bytes of a registered tensor (``register``: parameters, optimizer state
    and caches, each with the product of the mesh axes in its leaf's axis
    tuple, ``distributed.sharding.tree_param_specs`` or the dry run's cache
    rules) are divided by that product; so are the bytes of any tensor of a
    registered leaf's shape (a gradient, a weight cast to bf16, a moment
    update), which the sharding would split alike;
  * every other tensor (activations) and every FLOP is divided by the
    chips;
  * work that the reference's HLO shows replicated on every device of an
    axis (a norm computed on every model rank, say) is not modelled: the
    port divides it by the chips too. ROADMAP.md §3 lists this among the
    deliberate differences.

A program written as the sum of the devices' programs (the hqi roofline
step runs every (batch index, model rank) pair's scan) registers nothing:
its global count divided by the chips is the per-device count exactly.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter, defaultdict
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import cost as _kernel_cost

aten = torch.ops.aten

# allocators and other ops that move no data
_FREE = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh, aten.resize_, aten.set_,
}
# ops that write their first operand without reading it
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
# ops that read only the rows their index selects from their first operand
_GATHER = {aten.index, aten.index_select, aten.embedding, aten.gather}
# in-place ops that write only the rows their index selects of their first
# operand (those that accumulate read them too)
_SCATTER = {aten.index_put_, aten.index_copy_, aten.scatter_}
_SCATTER_ADD = {aten.index_add_, aten.scatter_add_}
# metadata queries: answered without counting
_METADATA = {
    aten.is_contiguous, aten.sym_is_contiguous, aten.is_strides_like_format,
    aten.is_non_overlapping_and_dense, aten.size, aten.sym_size, aten.stride, aten.sym_stride,
    aten.storage_offset, aten.sym_storage_offset, aten.numel, aten.sym_numel, aten.dim,
}


_DECOMPOSABLE: Dict[Any, bool] = {}


def _decomposable(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd kernel, that
    ``func.decompose`` would run (cached: the answer is the op's)."""
    known = _DECOMPOSABLE.get(func)
    if known is None:
        key = torch._C.DispatchKey.CompositeImplicitAutograd
        known = _DECOMPOSABLE[func] = func is not torch.ops.prim.device.default and (
            key in func.py_kernels or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), key))
    return known


def _tensors(items) -> List[torch.Tensor]:
    """The tensors among ``items``, and inside their lists and tuples (an
    op's arguments and results nest no deeper)."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def dtype_key(dtype: torch.dtype) -> str:
    """The compute-rate class of an op's operands: "bf16" or "f32"."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def _storage(t: torch.Tensor):
    return t.untyped_storage()


def touched_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads from (or writes to) ``t``: its elements, a dim of
    stride 0 (a broadcast) counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


@dataclasses.dataclass
class OpCost:
    """Per-device counts of one step (see the module docstring)."""

    flops_by_dtype: Dict[str, float]
    bytes: float
    peak_bytes: float
    kernels: Dict[str, int]  # kernel wrapper -> meta calls charged
    ops: int  # aten ops counted

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))


class OpCounter(TorchDispatchMode):
    """Counts a step's FLOPs, bytes and peak of live bytes (module
    docstring). ``chips`` divides the global counts into per-device ones;
    ``register`` names the sharded tensors that divide by their own axes."""

    supports_higher_order_operators = True

    def __init__(self, chips: int = 1):
        super().__init__()
        self.chips = int(chips)
        self._flops: Dict[str, float] = defaultdict(float)  # global
        self._bytes = 0.0  # per device
        self._live = 0.0
        self._peak = 0.0
        self._kernels: Counter = Counter()
        self._ops = 0
        self._divisor: Dict[int, int] = {}  # storage -> divisor, registered tensors
        self._shape_divisor: Dict[Tuple, int] = {}  # shape of a registered leaf -> divisor
        self._known: Dict[int, float] = {}  # storage -> its live bytes per device (0: an argument)

    # -- registration -------------------------------------------------------

    def register(self, tensors: Iterable[torch.Tensor], divisor: int) -> None:
        """``tensors`` (and any tensor of one's shape) are split ``divisor``
        ways across the devices."""
        for t in tensors:
            divisor = max(int(divisor), 1)
            self._divisor[_storage(t)._cdata] = divisor
            key = tuple(t.shape)
            self._shape_divisor[key] = min(self._shape_divisor.get(key, divisor), divisor)

    def _div(self, t: torch.Tensor) -> int:
        d = self._divisor.get(_storage(t)._cdata)
        if d is None:
            d = self._shape_divisor.get(tuple(t.shape), self.chips)
        return d

    # -- storage lifetimes --------------------------------------------------

    def _see(self, t: torch.Tensor, created: bool) -> None:
        st = _storage(t)
        key = st._cdata
        if key in self._known:
            return
        nbytes = st.nbytes() / self._div(t) if created else 0.0
        self._known[key] = nbytes
        self._live += nbytes
        self._peak = max(self._peak, self._live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._known.pop(key, 0.0)

    # -- counting -----------------------------------------------------------

    def _read_write(self, reads: Iterable[torch.Tensor], writes: Iterable[torch.Tensor]) -> None:
        for t in reads:
            self._bytes += touched_bytes(t) / self._div(t)
        for t in writes:
            self._bytes += touched_bytes(t) / self._div(t)

    def _indexed(self, packet, ins: List[torch.Tensor], outs: List[torch.Tensor]) -> None:
        """An indexing op's bytes: the indices and values read, and of its
        first operand only the rows the index selects."""
        base, rest = ins[0], ins[1:]
        if packet in _GATHER:
            rows = sum(touched_bytes(t) for t in outs) / self._div(base)
            self._bytes += rows
            self._read_write(rest, outs)
        else:  # a scatter into base, in place: its values' elements of base written
            values = max(rest, key=lambda t: t.numel())
            rows = touched_bytes(values) // values.element_size() * base.element_size() / self._div(base)
            self._bytes += rows * (2 if packet in _SCATTER_ADD else 1)
            self._read_write(rest, ())

    def charge_kernel(self, kernel: str, flops: float, dtype: torch.dtype, reads, writes) -> None:
        """A kernel wrapper's meta charge (``kernels.cost.charge``)."""
        self._flops[dtype_key(dtype)] += flops
        self._read_write(reads, writes)
        self._kernels[kernel] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = getattr(func, "overloadpacket", None)
        if packet in _METADATA or func is torch.ops.prim.layout.default:
            return NotImplemented
        if packet not in flop_registry and _decomposable(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ins = _tensors(args) + _tensors(kwargs.values())
        for t in ins:
            self._see(t, created=False)
        out = func(*args, **kwargs)
        outs = _tensors((out,))
        for t in outs:
            self._see(t, created=True)
        self._ops += 1
        if packet in flop_registry:
            self._flops[dtype_key(ins[0].dtype if ins else torch.float32)] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if outs and not func.is_view and packet not in _FREE:
            if packet in _GATHER or packet in _SCATTER or packet in _SCATTER_ADD:
                self._indexed(packet, ins, outs)
            else:
                self._read_write(ins[1:] if packet in _WRITE_ONLY else ins, outs)
        return out

    def __enter__(self):
        _kernel_cost._ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _kernel_cost._ACTIVE.remove(self)
        return super().__exit__(*exc)

    def result(self) -> OpCost:
        return OpCost(
            flops_by_dtype={k: v / self.chips for k, v in sorted(self._flops.items())},
            bytes=self._bytes,
            peak_bytes=self._peak,
            kernels=dict(self._kernels),
            ops=self._ops,
        )


def count(fn, *args, chips: int = 1, registered: Iterable[Tuple[Iterable[torch.Tensor], int]] = (),
          **kwargs) -> Tuple[Any, OpCost]:
    """Run ``fn(*args, **kwargs)`` under an ``OpCounter`` of ``chips``, the
    ``registered`` (tensors, divisor) pairs registered first; returns (its
    result, the ``OpCost``)."""
    counter = OpCounter(chips)
    for tensors, divisor in registered:
        counter.register(tensors, divisor)
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.result()
