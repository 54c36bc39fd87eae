"""Model API of the serving path: init / prefill / decode / cache.

The counterpart of the serving half of ``repro.models.api`` for the dense
family. Training (``loss_fn``) and the dry-run shape specs are not ported
yet (ROADMAP.md §1, the rest of the LM scaffolding).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import decode as dec
from .transformer import ModelConfig, init_lm


def init_model(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random weights drawn from ``gen``, on its device."""
    return init_lm(cfg, gen)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def count_params(params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def params_to(tree, device):
    """The same weights with every leaf moved to ``device``."""
    if isinstance(tree, dict):
        return {n: params_to(v, device) for n, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to(v, device) for v in tree)
    return tree.to(device)


def serve_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
                  max_len: Optional[int] = None):
    """batch {"tokens": int [B, S]} -> (last logits f32 [B, V], cache).
    ``max_len`` pads the KV cache past the prompt to leave room for
    decoding."""
    return dec.prefill(params, cfg, batch["tokens"], max_len=max_len)


def serve_decode(params, cfg: ModelConfig, token: torch.Tensor, cache):
    return dec.decode_step(params, cfg, token, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return dec.init_cache(cfg, batch, max_len, device=device)
