"""Attention: GQA with RoPE, qk-norm, optional QKV bias, sliding windows.

The counterpart of ``repro.models.attention``. Prefill and training run the
hand-written flash-attention kernels through
``kernels.flash_attention.flash_attention`` (on a CPU tensor the plain
versions: ``flash_attention_plain``, the chunked online softmax the
reference runs here, and under grad ``flash_attention_backward_plain``);
with grad enabled the call goes through an autograd ``Function`` whose
backward is the backward kernel.
Decode (one new token against a KV cache) is a masked one-step softmax in
plain torch, as in the reference. Without a device mesh the reference's
``shard_activation`` and ``_kv_repeat_for_tp`` are identities, so the port
has neither.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import NEG_INF, flash_attention
from .layers import dense_init, init_rmsnorm, rmsnorm, rope


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: Optional[int] = None
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q, k
    qkv_bias: bool = False  # qwen1.5-style
    rope_theta: float = 10000.0
    causal: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def init_attention(gen: torch.Generator, cfg: AttnConfig,
                   dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    dh = cfg.dh
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    p = {
        "wq": dense_init(gen, (cfg.d_model, hq), dtype=dtype),
        "wk": dense_init(gen, (cfg.d_model, hkv), dtype=dtype),
        "wv": dense_init(gen, (cfg.d_model, hkv), dtype=dtype),
        "wo": dense_init(gen, (hq, cfg.d_model), scale=hq**-0.5, dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((n,), dtype=dtype, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(dh, gen.device)
        p["k_norm"] = init_rmsnorm(dh, gen.device)
    return p


def qkv_project(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> q [B,S,Hq,dh], k/v [B,S,Hkv,dh] (roped, normed)."""
    b, s, _ = x.shape
    dh = cfg.dh
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, cfg.n_heads, dh)
    k = k.reshape(b, s, cfg.n_kv_heads, dh)
    v = v.reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, dh] — one new token
    k_cache: torch.Tensor,  # [B, T, Hkv, dh]
    v_cache: torch.Tensor,  # [B, T, Hkv, dh]
    cache_len: torch.Tensor,  # int [B] — valid prefix length (incl. new token)
    *,
    window: int = 0,
) -> torch.Tensor:
    b, _, hq, dh = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dh).to(torch.float32) * dh**-0.5
    logits = torch.einsum("bhgd,bthd->bhgt", qg, k_cache.to(torch.float32))
    pos = torch.arange(t, device=q.device)[None, :]  # [1, T]
    mask = pos < cache_len[:, None]
    if window > 0:
        mask = mask & (pos > cache_len[:, None] - 1 - window)
    logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, hq, dh).to(q.dtype)


def attention_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, S, D]
    cfg: AttnConfig,
    *,
    positions: torch.Tensor,
    window: int = 0,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_len: Optional[torch.Tensor] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full attention sub-block (projections + attention + output proj).

    Without cache: prefill; returns (out, (k, v)) for the cache.
    With cache: decode; x is [B, 1, D] and the new K/V are written into the
    given cache tensors in place at ``cache_len - 1`` (the reference returns
    updated copies; writing in place keeps one cache on the card). The
    caller keeps ``cache_len`` within the cache (``decode.decode_step``
    raises where the reference's ``dynamic_update_slice`` would clamp).
    """
    b, s, _ = x.shape
    q, k, v = qkv_project(p, x, cfg, positions)
    if kv_cache is None:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=cfg.causal,
                              window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
        new_cache = (k, v)
    else:
        kc, vc = kv_cache
        idx = cache_len - 1  # position of the new token, per batch row
        rows = torch.arange(b, device=x.device)
        kc[rows, idx] = k[:, 0].to(kc.dtype)
        vc[rows, idx] = v[:, 0].to(vc.dtype)
        out = decode_attention(q, kc, vc, cache_len, window=window)
        new_cache = (kc, vc)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype), new_cache
