"""Gradient compression for the data-parallel exchange — the counterpart of
``repro.distributed.compression``.

int8 uniform quantization with error feedback (EF-SGD style): each rank
quantizes (grad + residual), the int8 payloads are gathered over the data
ranks, dequantized and averaged, and each rank carries its own quantization
error into its next step. 4x less DP traffic than f32 (2x against bf16) at
the cost of a gather instead of a sum (int8 sums would overflow).

The arithmetic is the reference's, so the int8 codes and scales are
bit-equal to it: ``amax / 127`` in f32 clamped at 1e-12, ``torch.round``
(half to even, as ``jnp.round``), a clip to +-127, then int8.

The reference runs ``allreduce_compressed`` inside ``shard_map`` under an
axis name. The port is single-controller (``launch/mesh.py``): one process
holds every rank's payload, so ``allreduce_compressed`` takes them as lists
in rank order. Its "all-gather" brings every rank's payload to rank 0's
device (a copy for a rank on another device); the mean over the ranks
follows, as the reference's ``mean(axis=0)``.

Trees are the port's nested dicts and lists of tensors (``models/tree.py``).
The reference quantizes each of its stacked ``[L, ...]`` layer leaves with
one scale; the port's layer leaves are per layer, so ``compress_tree``
takes one scale over all L of them together (``tree.stack_key``), and its
codes, scales and residuals are the reference's leaf for leaf.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Sequence, Tuple

import torch

from ..models.tree import leaves, leaves_with_paths, stack_key, tree_map


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / 127.0, min=1e-12)


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q int8, scale f32 scalar)."""
    xf = x.to(torch.float32)
    scale = _scale(xf.abs().max())
    return _codes(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_tree(grads, residual):
    """(grads + residual) -> (q_tree, scale_tree, new_residual): one scale
    per stacked leaf of the reference (the same scalar at each of its
    layers' positions in ``scale_tree``)."""
    paths = [path for path, _ in leaves_with_paths(grads)]
    gs, rs = leaves(grads), leaves(residual)
    groups = defaultdict(list)
    for i, path in enumerate(paths):
        groups[stack_key(path)].append(i)
    q, s, res = [None] * len(gs), [None] * len(gs), [None] * len(gs)
    for idx in groups.values():
        xs = {i: gs[i].to(torch.float32) + rs[i] for i in idx}
        scale = _scale(torch.stack([xs[i].abs().max() for i in idx]).max())
        for i in idx:
            q[i], s[i] = _codes(xs[i], scale), scale
            res[i] = xs[i] - dequantize_int8(q[i], scale)
    return _unflatten(grads, q), _unflatten(grads, s), _unflatten(grads, res)


def _unflatten(like, flat):
    """``flat`` (in ``leaves`` order) at the leaf positions of ``like``."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)


@torch.no_grad()
def allreduce_compressed(q_trees: Sequence[Any], s_trees: Sequence[Any]):
    """Gather the ranks' int8 payloads (``q_trees[r]``, ``s_trees[r]`` in
    rank order) onto rank 0's device and average them there: per leaf the
    mean over ranks of ``q_r * s_r`` in f32, summed in rank order (no
    ``[N, ...]`` f32 stack: an embedding leaf's would take N x its f32
    bytes)."""
    if len(q_trees) != len(s_trees) or not q_trees:
        raise ValueError(f"{len(q_trees)} payloads and {len(s_trees)} scales; want one of each per rank")
    n = len(q_trees)

    def one(*qs_ss):
        qs, ss = qs_ss[:n], qs_ss[n:]
        dev = qs[0].device
        acc = dequantize_int8(qs[0], ss[0])
        for q, s in zip(qs[1:], ss[1:]):
            acc += dequantize_int8(q.to(dev), s.to(dev))
        return acc.div_(n)

    return tree_map(one, q_trees[0], *q_trees[1:], *s_trees)


def zero_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def payload_bytes(q_tree, s_tree) -> int:
    """Bytes one rank sends: its int8 codes and one f32 scale per stacked
    leaf (the layers of one share their scale tensor)."""
    scales = {id(s): s for s in leaves(s_tree)}.values()
    return sum(q.numel() for q in leaves(q_tree)) + sum(4 * s.numel() for s in scales)
