"""Carry the reference's parameters into the port, and back out.

``params_from_jax`` takes the pytree that ``repro.models.api.init_model``
returns, as numpy arrays (``jax.tree.map(np.asarray, params)``), with the
stacked ``[L, ...]`` leaves of its layer lists (``tree.STACKED``:
``layers``, a moe model's ``dense_layers``, an encdec model's
``enc_layers`` and ``dec_layers``), and returns the port's parameter dict:
each list unstacked (a hybrid's ``shared_attn`` stays one dict), matmul
weights and biases in ``cfg.dtype``; norm weights, embedding tables, a moe
router and the SSM's ``conv_w``, ``A_log``, ``dt_bias`` and ``D`` in f32
(what the reference's per-use casts give: it reads ``conv_w`` and the
router in f32, so a copy in ``cfg.dtype`` would round where the reference
does not); with ``masters=True`` every leaf in f32,
as the reference keeps them for training. Both packages then compute the
same function, which is how the tests compare them. ``params_to_numpy`` is
the inverse: the port's tree (parameters, or an optimizer state of the same
structure) as numpy arrays with the layers stacked again, so updated trees
compare leaf by leaf. This module imports neither jax nor the reference: it
reads and writes plain arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .transformer import ModelConfig, require_ported
from .tree import STACKED

_F32_LEAVES = ("embedding", "lm_head", "final_norm", "attn_norm", "mlp_norm", "q_norm", "k_norm", "norm",
               "xattn_norm", "enc_norm", "conv_w", "A_log", "dt_bias", "D", "router")


def _tensor(name: str, arr, dtype, device) -> torch.Tensor:
    dtype = torch.float32 if name in _F32_LEAVES else dtype
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)


def _convert(tree: Dict[str, Any], dtype, device) -> Dict[str, Any]:
    return {name: _convert(v, dtype, device) if isinstance(v, dict) else _tensor(name, v, dtype, device)
            for name, v in tree.items()}


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {name: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for name, v in tree.items()}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cuda", *,
                    masters: bool = False) -> Dict[str, Any]:
    require_ported(cfg)
    dtype = torch.float32 if masters else cfg.dtype
    params = {}
    for key, v in tree.items():
        if key in STACKED:
            n = len(np.asarray(_first_leaf(v)))
            params[key] = [_convert(_layer(v, i), dtype, device) for i in range(n)]
        else:
            params[key] = _convert(v, dtype, device) if isinstance(v, dict) else _tensor(key, v, dtype, device)
    return params


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(device="cpu", dtype=torch.float32).numpy()


def params_to_numpy(tree) -> Dict[str, Any]:
    """The port's tree as numpy f32 arrays in the reference's layout: each
    list of ``tree.STACKED`` becomes one dict of ``[L, ...]`` stacked leaves."""
    if isinstance(tree, dict):
        return {k: _stack(v) if k in STACKED else params_to_numpy(v) for k, v in tree.items()}
    return _numpy(tree)


def _stack(layers):
    per = [params_to_numpy(lp) for lp in layers]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack(xs)

    return stack(*per)
