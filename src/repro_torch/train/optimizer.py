"""Optimizers: AdamW and Adafactor, with cosine / WSD / constant schedules.

The counterpart of ``repro.train.optimizer``, as plain functions on trees
of tensors. The state keeps the reference's keys: AdamW ``{"m", "v",
"step"}``, Adafactor ``{"slots", "step"}`` with a slot of ``{"vr", "vc"}``
(factored second moment) or ``{"v"}`` per leaf; ``step`` is an int32
scalar on the parameters' device, and every moment is f32.

``apply_opt`` updates the parameters and the state **in place** and returns
them (the reference returns new trees): at minicpm-2b's width the masters,
gradients and both moments take 4 x 10.9 GB, and a second copy of three of
them would not fit beside them on an 80 GB card. Call it under
``torch.no_grad()`` when the parameters require grad (``make_train_step``
does).

Adafactor clips each update to RMS 1 over the reference's *stacked* leaf:
the reference's ``layers/attn/wq`` is one ``[L, ...]`` array, the port's L
tensors, so the clip's mean runs over all L of them together
(``tree.stack_key``). WSD (warmup–stable–decay) is minicpm's schedule
(arXiv:2404.06395).
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

import torch

from ..models.tree import leaves, leaves_with_paths, stack_key, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | wsd | constant
    wsd_decay_frac: float = 0.1  # last 10% of steps decay (WSD)
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    # adafactor
    factored_min_dim: int = 128
    decay_rate: float = 0.8


def make_schedule(cfg: OptConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (int tensor) -> learning rate (f32 tensor on the step's device),
    the reference's arithmetic in f32: the first step's rate is 0."""
    if cfg.schedule not in ("constant", "cosine", "wsd"):
        raise ValueError(cfg.schedule)

    def sched(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.schedule == "constant":
            post = torch.ones_like(step)
        elif cfg.schedule == "cosine":
            t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
            post = 0.5 * (1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * t))
        else:  # wsd: a linear decay tail after the stable phase
            decay_start = cfg.total_steps * (1 - cfg.wsd_decay_frac)
            t = torch.clamp((step - decay_start) / max(cfg.total_steps - decay_start, 1), 0, 1)
            post = 1.0 - t
        return cfg.peak_lr * warm * post

    return sched


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def _step_scalar(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _device_of(params) -> torch.device:
    return leaves(params)[0].device


def _write(p: torch.Tensor, new: torch.Tensor) -> None:
    """``p <- new`` cast to p's type (the reference's ``astype(p.dtype)``)."""
    if new.data_ptr() != p.data_ptr():
        p.copy_(new)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": _step_scalar(_device_of(params))}


def adamw_update(params, grads, state, cfg: OptConfig, lr: torch.Tensor):
    step = state["step"] + 1
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device) ** stepf
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device) ** stepf
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"])):
        g = _f32(g)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        pf = _f32(p)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * pf
        _write(p, pf - lr * upd)
    state["step"] = step
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), no first moment
# ---------------------------------------------------------------------------


def _factored(p: torch.Tensor, cfg: OptConfig) -> bool:
    return p.dim() >= 2 and p.shape[-1] >= cfg.factored_min_dim and p.shape[-2] >= cfg.factored_min_dim


def adafactor_init(params, cfg: OptConfig) -> Dict[str, Any]:
    def init(p):
        z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
        if _factored(p, cfg):
            return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
        return {"v": z(p.shape)}

    return {"slots": tree_map(init, params), "step": _step_scalar(_device_of(params))}


def adafactor_update(params, grads, state, cfg: OptConfig, lr: torch.Tensor):
    step = state["step"] + 1
    beta2 = 1.0 - step.to(torch.float32) ** (-cfg.decay_rate)
    # leaf lists in one order; the slots are dicts at the leaves' positions
    ps = list(leaves_with_paths(params))
    gs = leaves(grads)
    slot_of = {path: slot for path, slot in _slot_leaves(state["slots"])}
    updates, groups = [], defaultdict(list)
    for i, ((path, p), g) in enumerate(zip(ps, gs)):
        slot = slot_of[path]
        g = _f32(g)
        g2 = g * g + 1e-30
        if "vr" in slot:
            slot["vr"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-1))
            slot["vc"].mul_(beta2).add_((1 - beta2) * g2.mean(dim=-2))
            vr, vc = slot["vr"], slot["vc"]
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
            u = g / torch.sqrt(r[..., None] * vc[..., None, :] + 1e-30)
        else:
            slot["v"].mul_(beta2).add_((1 - beta2) * g2)
            u = g / torch.sqrt(slot["v"] + 1e-30)
        updates.append(u)
        groups[stack_key(path)].append(i)
    # update clipping (RMS <= 1), over each stacked leaf of the reference
    for idx in groups.values():
        total = sum(updates[i].numel() for i in idx)
        sq = torch.stack([(updates[i] * updates[i]).sum() for i in idx]).sum()
        rms = torch.sqrt(sq / total + 1e-30)
        denom = torch.clamp(rms, min=1.0)
        for i in idx:
            p = ps[i][1]
            pf = _f32(p)
            _write(p, pf - lr * (updates[i] / denom) - lr * cfg.weight_decay * pf)
    state["step"] = step
    return params, state


def _slot_leaves(slots, path=()):
    """(path, slot dict) of every parameter's slot in an Adafactor tree."""
    if isinstance(slots, dict) and ("v" in slots or "vr" in slots):
        yield path, slots
    elif isinstance(slots, dict):
        for k, v in slots.items():
            yield from _slot_leaves(v, path + (k,))
    else:
        for i, v in enumerate(slots):
            yield from _slot_leaves(v, path + (i,))


# ---------------------------------------------------------------------------
# unified facade
# ---------------------------------------------------------------------------


def init_opt(params, cfg: OptConfig):
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    raise ValueError(cfg.name)


@torch.no_grad()
def apply_opt(params, grads, state, cfg: OptConfig, step_for_lr: Optional[torch.Tensor] = None):
    """One update, in place; the rate is the schedule's at ``state["step"]``
    *before* its increment (so the first update has rate 0 under warmup)."""
    lr = make_schedule(cfg)(step_for_lr if step_for_lr is not None else state["step"])
    if cfg.name == "adamw":
        return adamw_update(params, grads, state, cfg, lr)
    if cfg.name == "adafactor":
        return adafactor_update(params, grads, state, cfg, lr)
    raise ValueError(cfg.name)


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x²), in f32."""
    return torch.sqrt(torch.stack([(_f32(x) * _f32(x)).sum() for x in leaves(tree)]).sum())


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float):
    """Scales every leaf by ``min(1, max_norm / max(norm, 1e-9))`` in place
    (f32 product, cast back) and returns (tree, norm). Not
    ``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``."""
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    for x in leaves(tree):
        _write(x, _f32(x) * scale)
    return tree, n
