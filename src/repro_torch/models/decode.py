"""Prefill + single-token decode for the dense, ssm and hybrid families (the
serving path).

The counterpart of ``repro.models.decode``. Cache layouts as in the
reference, with ``len`` int32 [B], the tokens already in the cache:

  dense:  k/v [L, B, T, Hkv, dh] in the model's dtype
  ssm:    ssm [L, B, H, N, P] in f32, conv [L, B, W-1, C] in the model's dtype
  hybrid: ssm [G, E, B, H, N, P], conv [G, E, B, W-1, C] (G groups of E ssm
          layers) and k/v [G, B, T, Hkv, dh], one K/V per use of the shared
          attention block

``BATCH_AXIS`` names each leaf's batch axis. ``decode_step`` writes the new
token's K/V and the new SSM and conv states into the cache tensors in place
and returns the cache dict with the new ``len``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .transformer import ModelConfig, dense_body, embed_tokens, logits_of, require_ported, ssm_body

# the batch axis of each cache leaf, by family
BATCH_AXIS = {
    "dense": {"len": 0, "k": 1, "v": 1},
    "ssm": {"len": 0, "ssm": 1, "conv": 1},
    "hybrid": {"len": 0, "ssm": 2, "conv": 2, "k": 1, "v": 1},
}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    require_ported(cfg)
    dtype = dtype or cfg.dtype
    cache: Dict[str, Any] = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    n_attn = cfg.n_layers if cfg.family == "dense" else cfg.n_groups if cfg.family == "hybrid" else 0
    if cfg.family != "dense":
        s = cfg.ssm
        lead = (cfg.n_layers,) if cfg.family == "ssm" else (cfg.n_groups, cfg.hybrid_attn_every)
        cache["ssm"] = torch.zeros(lead + (batch, s.n_heads, s.d_state, s.head_dim), dtype=torch.float32,
                                   device=device)
        cache["conv"] = torch.zeros(lead + (batch, s.conv_width - 1, s.d_inner + 2 * s.d_state), dtype=dtype,
                                    device=device)
    if n_attn:
        shape = (n_attn, batch, max_len, cfg.n_kv_heads, cfg.dh)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def _ssm_layers(cfg: ModelConfig):
    """(layer index, cache index) of every ssm layer: ``i`` for ssm,
    ``(group, layer in group)`` for hybrid."""
    if cfg.family == "ssm":
        return [(i, i) for i in range(cfg.n_layers)]
    e = cfg.hybrid_attn_every
    return [(i, divmod(i, e)) for i in range(cfg.n_layers)]


def prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # int [B, S]
    *,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits of the last position f32 [B, V], cache covering the
    prompt). ``max_len`` > S allocates the K/V cache that long, zero past the
    prompt (the reference pads it in ``api.serve_prefill``); SSM states are
    O(1) and need none."""
    require_ported(cfg)
    x = embed_tokens(params, cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = init_cache(cfg, b, max(s, max_len or s), device=x.device)
    cache["len"].fill_(s)

    def attend(x, lp, w, i):
        x, (k, v) = dense_body(cfg, lp, x, positions, w)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        return x

    if cfg.family == "dense":
        for i, (lp, w) in enumerate(zip(params["layers"], cfg.layer_windows())):
            x = attend(x, lp, w, i)
    else:
        e = cfg.hybrid_attn_every
        for i, at in _ssm_layers(cfg):
            x, st = ssm_body(cfg, params["layers"][i], x)
            cache["ssm"][at] = st["ssm"]
            cache["conv"][at] = st["conv"]
            if cfg.family == "hybrid" and (i + 1) % e == 0:
                x = attend(x, params["shared_attn"], 0, i // e)
    return logits_of(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    token: torch.Tensor,  # int [B] — the newest token
    cache: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits f32 [B, V], cache). The new token goes to index
    ``cache["len"]``; where the cache has K/V, a row whose K/V cache is full
    raises ``ValueError`` (the reference's ``dynamic_update_slice`` would
    clamp the index and overwrite the last entry). An SSM state has no
    length limit."""
    require_ported(cfg)
    new_len = cache["len"] + 1
    if "k" in cache:
        t = cache["k"].shape[2]
        longest = int(new_len.max())
        if longest > t:
            raise ValueError(f"decode_step: a cache row would hold {longest} tokens, "
                             f"beyond its max_len {t}")
    positions = (new_len - 1)[:, None]  # [B, 1]
    x = embed_tokens(params, cfg, token[:, None])

    def attend(x, lp, w, i):
        return dense_body(cfg, lp, x, positions, w, (cache["k"][i], cache["v"][i]), new_len)[0]

    if cfg.family == "dense":
        for i, (lp, w) in enumerate(zip(params["layers"], cfg.layer_windows())):
            x = attend(x, lp, w, i)
    else:
        e = cfg.hybrid_attn_every
        for i, at in _ssm_layers(cfg):
            x, st = ssm_body(cfg, params["layers"][i], x, {"ssm": cache["ssm"][at], "conv": cache["conv"][at]})
            cache["ssm"][at] = st["ssm"]
            cache["conv"][at] = st["conv"]
            if cfg.family == "hybrid" and (i + 1) % e == 0:
                # the group's own K/V, the global window (the reference's jnp.int32(0))
                x = attend(x, params["shared_attn"], 0, i // e)
    return logits_of(params, cfg, x)[:, 0], dict(cache, len=new_len)
