"""The train step: loss -> grads (microbatched, remat'd) -> clip -> update.

The counterpart of ``repro.train.train_step``. The parameters are f32
masters that require grad (``init_train_state``); the layers cast them to
the model's compute type at each use. Microbatches run one after another and
autograd sums their gradients into the masters' f32 ``.grad`` (the
reference's ``lax.scan`` sums f32 gradients from zero), then the sum is
divided by the count, clipped by the global norm and applied in place
(``optimizer.apply_opt``). The loss is the microbatches' mean; the aux
values are the last microbatch's, as the reference's ``aux[-1]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from ..models import api
from ..models.transformer import ModelConfig
from .optimizer import OptConfig, apply_opt, clip_by_global_norm, init_opt
from ..models.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    grad_dtype: Any = torch.float32  # gradients accumulate in f32 (the masters' type)


def make_train_step(model_cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating ``params`` and ``opt_state`` in place. batch leaves
    have leading dim = global batch; with microbatching, microbatch i is
    rows [i·B/m, (i+1)·B/m), as the reference's reshape to [m, B/m, ...]."""
    if tcfg.grad_dtype != torch.float32:
        raise ValueError(f"gradients accumulate in the f32 masters' .grad, not {tcfg.grad_dtype}")

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        ps = leaves(params)
        for p in ps:
            if p.dtype != torch.float32:
                raise TypeError(f"train_step wants f32 masters (init_train_state); got a {p.dtype} leaf")
            p.requires_grad_(True)
            p.grad = None
        m = max(tcfg.microbatches, 1)
        b = batch["tokens"].shape[0]
        if b % m:
            raise ValueError(f"global batch {b} is not a multiple of {m} microbatches")
        per = b // m
        loss_sum = None
        for i in range(m):
            mb = {k: x[i * per:(i + 1) * per] for k, x in batch.items()}
            loss, aux = api.loss_fn(params, model_cfg, mb)
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), params)
        if m > 1:
            for g in leaves(grads):
                g.div_(m)
            loss_sum = loss_sum / m
        grads, gnorm = clip_by_global_norm(grads, tcfg.opt.clip_norm)
        params, opt_state = apply_opt(params, grads, opt_state, tcfg.opt)
        for p in ps:
            p.grad = None
        metrics = {"loss": loss_sum, "grad_norm": gnorm, **{k: v.detach() for k, v in aux.items()}}
        return params, opt_state, metrics

    return train_step


def init_train_state(model_cfg: ModelConfig, tcfg: TrainConfig, gen: torch.Generator) -> Tuple[Any, Any]:
    """(f32 master parameters that require grad, optimizer state), on
    ``gen``'s device."""
    params = api.init_model(model_cfg, gen, masters=True)
    for p in leaves(params):
        p.requires_grad_(True)
    return params, init_opt(params, tcfg.opt)
