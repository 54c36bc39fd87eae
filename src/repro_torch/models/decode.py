"""Prefill + single-token decode for the decoder-only families (the
serving path); the encdec family's are ``encdec.encdec_prefill`` and
``encdec_decode_step``.

The counterpart of ``repro.models.decode``. Cache layouts as in the
reference, with ``len`` int32 [B], the tokens already in the cache:

  dense/vlm/moe: k/v [L, B, T, Hkv, dh] in the model's dtype (moe: the
          leading dense layers first, then the moe layers)
  ssm:    ssm [L, B, H, N, P] in f32, conv [L, B, W-1, C] in the model's dtype
  hybrid: ssm [G, E, B, H, N, P], conv [G, E, B, W-1, C] (G groups of E ssm
          layers) and k/v [G, B, T, Hkv, dh], one K/V per use of the shared
          attention block
  encdec: k/v [L, B, T, Hkv, dh] and the cross K/V xk/xv [L, B, F, Hkv, dh]

``BATCH_AXIS`` names each leaf's batch axis. ``decode_step`` writes the new
token's K/V and the new SSM and conv states into the cache tensors in place
and returns the cache dict with the new ``len``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .transformer import (ModelConfig, dense_body, embed_tokens, layer_plan, logits_of, require_ported,
                          ssm_body)

# the batch axis of each cache leaf, by family
BATCH_AXIS = {
    "dense": {"len": 0, "k": 1, "v": 1},
    "vlm": {"len": 0, "k": 1, "v": 1},
    "moe": {"len": 0, "k": 1, "v": 1},
    "ssm": {"len": 0, "ssm": 1, "conv": 1},
    "hybrid": {"len": 0, "ssm": 2, "conv": 2, "k": 1, "v": 1},
    "encdec": {"len": 0, "k": 1, "v": 1, "xk": 1, "xv": 1},
}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    require_ported(cfg)
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.family}: encdec.init_encdec_cache builds its cache")
    dtype = dtype or cfg.dtype
    cache: Dict[str, Any] = {"len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    attn_only = cfg.family in ("dense", "vlm", "moe")
    n_attn = cfg.n_layers if attn_only else cfg.n_groups if cfg.family == "hybrid" else 0
    if not attn_only:
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
    vision_embeds: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits of the last position f32 [B, V], cache covering the
    prompt). A vlm's ``vision_embeds`` [B, P, D] go first, so the cache
    holds P + S positions. ``max_len`` > P + S allocates the K/V cache that
    long, zero past the prompt (the reference pads it in
    ``api.serve_prefill``); SSM states are O(1) and need none. A moe
    model's experts run at the training capacity factor here, as the
    reference's prefill calls ``moe_layer`` with ``serving=False``, so a
    prefill can drop pairs (``lm_forward``'s aux values on the same prompt
    say how many: it routes alike)."""
    require_ported(cfg)
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    cache = init_cache(cfg, b, max(s, max_len or s), device=x.device)
    cache["len"].fill_(s)

    def store(i, kv):
        cache["k"][i, :, :s] = kv[0]
        cache["v"][i, :, :s] = kv[1]

    if cfg.family in ("dense", "vlm", "moe"):
        for i, (body, lp, w) in enumerate(layer_plan(params, cfg)):
            out = body(cfg, lp, x, positions, w)
            x = out[0]
            store(i, out[1])
    else:
        e = cfg.hybrid_attn_every
        for i, at in _ssm_layers(cfg):
            x, st = ssm_body(cfg, params["layers"][i], x)
            cache["ssm"][at] = st["ssm"]
            cache["conv"][at] = st["conv"]
            if cfg.family == "hybrid" and (i + 1) % e == 0:
                x, kv = dense_body(cfg, params["shared_attn"], x, positions, 0)
                store(i // e, kv)
    return logits_of(params, cfg, x[:, -1:])[:, 0], cache


def check_room(cache: Dict[str, Any], new_len: torch.Tensor) -> None:
    """Raise ``ValueError`` where a row's K/V cache cannot take one more
    token (the reference's ``dynamic_update_slice`` would clamp the index
    and overwrite the last entry). On ``meta`` tensors (the dry run) the
    check is skipped: a meta tensor holds no lengths to read."""
    if new_len.device.type == "meta":
        return
    t = cache["k"].shape[2]
    longest = int(new_len.max())
    if longest > t:
        raise ValueError(f"decode_step: a cache row would hold {longest} tokens, beyond its max_len {t}")


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    token: torch.Tensor,  # int [B] — the newest token
    cache: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (logits f32 [B, V], cache). The new token goes to index
    ``cache["len"]``; where the cache has K/V, a row whose K/V cache is full
    raises ``ValueError`` (``check_room``). An SSM state has no length
    limit. A moe model runs its leading dense layers, then its moe layers at
    the serving capacity factor, over the one cache (the reference's
    ``_decode_scan_split``)."""
    require_ported(cfg)
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.family}: encdec.encdec_decode_step decodes it")
    new_len = cache["len"] + 1
    if "k" in cache:
        check_room(cache, new_len)
    positions = (new_len - 1)[:, None]  # [B, 1]
    x = embed_tokens(params, cfg, token[:, None])

    def attend(body, x, lp, w, i):
        return body(cfg, lp, x, positions, w, (cache["k"][i], cache["v"][i]), new_len)[0]

    if cfg.family in ("dense", "vlm", "moe"):
        for i, (body, lp, w) in enumerate(layer_plan(params, cfg)):
            x = attend(body, x, lp, w, i)
    else:
        e = cfg.hybrid_attn_every
        for i, at in _ssm_layers(cfg):
            x, st = ssm_body(cfg, params["layers"][i], x, {"ssm": cache["ssm"][at], "conv": cache["conv"][at]})
            cache["ssm"][at] = st["ssm"]
            cache["conv"][at] = st["conv"]
            if cfg.family == "hybrid" and (i + 1) % e == 0:
                # the group's own K/V, the global window (the reference's jnp.int32(0))
                x = attend(dense_body, x, params["shared_attn"], 0, i // e)
    return logits_of(params, cfg, x)[:, 0], dict(cache, len=new_len)
