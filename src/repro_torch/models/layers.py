"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

The counterpart of ``repro.models.layers``. Parameters are plain dicts of
tensors and every layer is a function. Initializers draw from an explicit
``torch.Generator`` on the generator's device. Matmul weights are stored in
the model's working dtype (the reference keeps f32 masters and casts them at
each use, which gives the same product); norm weights and embedding tables
stay f32, since ``rmsnorm`` and ``unembed`` read them in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, 1/fan_in) by default, drawn in f32 and stored in ``dtype``."""
    scale = scale if scale is not None else 1.0 / (shape[0] ** 0.5)
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 with the ``(1 + w)`` offset form, cast back to x's type."""
    dt = x.dtype
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * (1.0 + w.to(torch.float32))).to(dt)


def init_rmsnorm(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split (not interleaved). x [..., S, H, Dh] (Dh
    even), positions [..., S]; the rotation runs in f32."""
    dh = x.shape[-1]
    half = dh // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32, device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, gated: bool = True,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
    }
    if gated:
        p["w_gate"] = dense_init(gen, (d_model, d_ff), dtype=dtype)
    return p


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        h = _act(x @ p["w_gate"], act) * up
    else:
        h = _act(up, act)
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int) -> torch.Tensor:
    return dense_init(gen, (vocab, d_model), scale=d_model**-0.5)


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``table.astype(dtype)[tokens]``: the gathered rows are cast, which gives
    the same values without a cast copy of the whole table."""
    return table[tokens].to(dtype)


def embed_scale(d_model: int, dtype: torch.dtype) -> torch.Tensor:
    """gemma's ``sqrt(d)`` embedding multiplier, rounded to the working type
    as the reference rounds it (73.5 for d = 5376 in bf16)."""
    return torch.tensor(math.sqrt(d_model), dtype=dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits in f32: hidden and table both in f32."""
    return x.to(torch.float32) @ table.to(torch.float32).T
