"""Prefill + single-token decode for the dense family (the serving path).

The counterpart of ``repro.models.decode``. Cache layout as in the
reference: k/v [L, B, T, Hkv, dh] in the model's dtype, and ``len`` int32
[B], the tokens already in the cache. ``decode_step`` writes the new
token's K/V into the cache tensors in place and returns the cache dict with
the new ``len``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .transformer import ModelConfig, dense_body, embed_tokens, logits_of, require_dense


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    require_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    dtype = dtype or cfg.dtype
    return {
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # int [B, S]
    *,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits of the last position f32 [B, V], cache covering the
    prompt). ``max_len`` > S allocates the cache that long, zero past the
    prompt (the reference pads it in ``api.serve_prefill``)."""
    require_dense(cfg)
    x = embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = init_cache(cfg, b, max(s, max_len or s), device=x.device)
    cache["len"].fill_(s)
    for i, (lp, w) in enumerate(zip(params["layers"], cfg.layer_windows())):
        x, (k, v) = dense_body(cfg, lp, x, positions, w)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    return logits_of(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    token: torch.Tensor,  # int [B] — the newest token
    cache: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits f32 [B, V], cache). The new token goes to index
    ``cache["len"]``; a row whose cache is full raises ``ValueError`` (the
    reference's ``dynamic_update_slice`` would clamp the index and overwrite
    the last entry)."""
    require_dense(cfg)
    new_len = cache["len"] + 1
    t = cache["k"].shape[2]
    longest = int(new_len.max())
    if longest > t:
        raise ValueError(f"decode_step: a cache row would hold {longest} tokens, "
                         f"beyond its max_len {t}")
    positions = (new_len - 1)[:, None]  # [B, 1]
    x = embed_tokens(params, cfg, token[:, None])
    for i, (lp, w) in enumerate(zip(params["layers"], cfg.layer_windows())):
        x, _ = dense_body(cfg, lp, x, positions, w, (cache["k"][i], cache["v"][i]), new_len)
    return logits_of(params, cfg, x)[:, 0], dict(cache, len=new_len)
