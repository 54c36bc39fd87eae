"""Carry the reference's parameters into the port.

``params_from_jax`` takes the pytree that ``repro.models.api.init_model``
returns, as numpy arrays (``jax.tree.map(np.asarray, params)``), with the
stacked ``[L, ...]`` layer leaves of ``init_lm``, and returns the port's
parameter dict: the layers unstacked into a list, matmul weights and biases
in ``cfg.dtype``, norm weights and embedding tables in f32 (what the
reference's per-use casts give). Both packages then compute the same
function, which is how the tests compare them. This module imports neither
jax nor the reference: it reads plain arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .transformer import ModelConfig, require_dense

_F32_LEAVES = ("embedding", "lm_head", "final_norm", "attn_norm", "mlp_norm", "q_norm", "k_norm")


def _tensor(name: str, arr, cfg: ModelConfig, device) -> torch.Tensor:
    dtype = torch.float32 if name in _F32_LEAVES else cfg.dtype
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)


def _convert(tree: Dict[str, Any], cfg: ModelConfig, device) -> Dict[str, Any]:
    return {name: _convert(v, cfg, device) if isinstance(v, dict) else _tensor(name, v, cfg, device)
            for name, v in tree.items()}


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {name: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for name, v in tree.items()}


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device="cuda") -> Dict[str, Any]:
    require_dense(cfg)
    params = _convert({k: v for k, v in tree.items() if k != "layers"}, cfg, device)
    params["layers"] = [_convert(_layer(tree["layers"], i), cfg, device)
                        for i in range(cfg.n_layers)]
    return params
