"""Whisper-style encoder-decoder backbone.

The counterpart of ``repro.models.encdec``. As in the reference the
conv/audio frontend is a stub: the caller gives precomputed frame
embeddings [B, F, d_model] (as if emitted by the two-conv downsampler). The
encoder is bidirectional attention over the frames, through the flash
kernels with ``causal=False`` (under grad their backward too); the decoder
is a causal LM with cross-attention to the encoder output. Both apply RoPE
in their self-attention (``qkv_project``) on top of the sinusoids, as the
reference does, and their MLPs are ungated GeLU (tanh approximation).
Cross-attention is plain torch in f32, as the reference's ``jnp`` einsums:
no Pallas kernel runs it there.

Parameters: ``embedding``, ``enc_layers`` (a list of ``{"attn_norm",
"attn", "mlp_norm", "mlp"}``), ``enc_norm``, ``dec_layers`` (a list of
``{"attn_norm", "attn", "xattn_norm", "xattn", "mlp_norm", "mlp"}``) and
``final_norm``. With ``cfg.remat`` and grad enabled each layer is a
``torch.utils.checkpoint`` region.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import AttnConfig, attention_block, init_attention
from .decode import check_room
from .layers import embed, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm, unembed
from .transformer import ModelConfig


def sinusoids(length: int, channels: int, device="cpu") -> torch.Tensor:
    """f32 [length, channels]: sin then cos of ``position * 10000^(-i/(half-1))``."""
    half = channels // 2
    inv = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device) / (half - 1))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _cross_attention(p, x: torch.Tensor, enc_kv, cfg: AttnConfig) -> torch.Tensor:
    """x [B, S, D] attends to precomputed encoder K/V [B, F, Hkv, dh]; the
    softmax and both products in f32."""
    b, s, _ = x.shape
    dh = cfg.dh
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads, dh)
    k, v = enc_kv
    hkv = k.shape[2]
    g = cfg.n_heads // hkv
    logits = torch.einsum("bshgd,bfhd->bhgsf", q.reshape(b, s, hkv, g, dh).to(torch.float32) * dh**-0.5,
                          k.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgsf,bfhd->bshgd", probs, v.to(torch.float32))
    return out.reshape(b, s, -1).to(x.dtype) @ p["wo"].to(x.dtype)


def cross_kv(p, enc_out: torch.Tensor, cfg: AttnConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    b, f, _ = enc_out.shape
    k = (enc_out @ p["wk"].to(enc_out.dtype)).reshape(b, f, cfg.n_kv_heads, cfg.dh)
    v = (enc_out @ p["wv"].to(enc_out.dtype)).reshape(b, f, cfg.n_kv_heads, cfg.dh)
    return k, v


def init_encdec(cfg: ModelConfig, gen: torch.Generator, *, masters: bool = False) -> Dict[str, Any]:
    """Random weights on ``gen``'s device; matmul weights in ``cfg.dtype``,
    every leaf f32 with ``masters`` (as ``transformer.init_lm``)."""
    dtype = torch.float32 if masters else cfg.dtype
    dev = gen.device

    def enc_layer():
        return {
            "attn_norm": init_rmsnorm(cfg.d_model, dev),
            "attn": init_attention(gen, cfg.attn_cfg(causal=False), dtype=dtype),
            "mlp_norm": init_rmsnorm(cfg.d_model, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False, dtype=dtype),
        }

    def dec_layer():
        return {
            "attn_norm": init_rmsnorm(cfg.d_model, dev),
            "attn": init_attention(gen, cfg.attn_cfg(causal=True), dtype=dtype),
            "xattn_norm": init_rmsnorm(cfg.d_model, dev),
            "xattn": init_attention(gen, cfg.attn_cfg(causal=False), dtype=dtype),
            "mlp_norm": init_rmsnorm(cfg.d_model, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False, dtype=dtype),
        }

    return {
        "embedding": init_embedding(gen, cfg.vocab, cfg.d_model),
        "enc_layers": [enc_layer() for _ in range(cfg.encoder_layers)],
        "enc_norm": init_rmsnorm(cfg.d_model, dev),
        "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        "final_norm": init_rmsnorm(cfg.d_model, dev),
    }


def _run(fns, x: torch.Tensor, remat: bool) -> torch.Tensor:
    remat = remat and torch.is_grad_enabled()
    for fn in fns:
        x = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    return x


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, F, D] (the stub frontend's output) -> encoder states [B, F, D]."""
    b, f, _ = frames.shape
    x = frames.to(cfg.dtype) + sinusoids(f, cfg.d_model, frames.device).to(cfg.dtype)[None]
    positions = torch.arange(f, device=x.device)[None, :].expand(b, f)
    acfg = cfg.attn_cfg(causal=False)

    def layer(lp):
        def fn(x):
            h, _ = attention_block(lp["attn"], rmsnorm(x, lp["attn_norm"]), acfg, positions=positions,
                                   q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
            x = x + h
            return x + mlp(lp["mlp"], rmsnorm(x, lp["mlp_norm"]), act="gelu")
        return fn

    x = _run([layer(lp) for lp in params["enc_layers"]], x, cfg.remat)
    return rmsnorm(x, params["enc_norm"])


def _dec_layer(cfg: ModelConfig, lp, x, positions, *, enc_out=None, enc_kv=None, kv_cache=None, cache_len=None):
    """One decoder layer: causal self-attention (prefill/training, or one
    step against ``kv_cache``), cross-attention to ``enc_out``'s K/V (or the
    cached ``enc_kv``), the MLP. Returns (x, (k, v), (xk, xv))."""
    acfg = cfg.attn_cfg()
    h, kv = attention_block(lp["attn"], rmsnorm(x, lp["attn_norm"]), acfg, positions=positions,
                            kv_cache=kv_cache, cache_len=cache_len, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    x = x + h
    if enc_kv is None:
        enc_kv = cross_kv(lp["xattn"], enc_out, acfg)
    x = x + _cross_attention(lp["xattn"], rmsnorm(x, lp["xattn_norm"]), enc_kv, acfg)
    x = x + mlp(lp["mlp"], rmsnorm(x, lp["mlp_norm"]), act="gelu")
    return x, kv, enc_kv


def decode_train(params, cfg: ModelConfig, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder -> logits f32 [B, S, V]."""
    b, s = tokens.shape
    x = embed(params["embedding"], tokens, cfg.dtype)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)

    def layer(lp):
        return lambda x: _dec_layer(cfg, lp, x, positions, enc_out=enc_out)[0]

    x = _run([layer(lp) for lp in params["dec_layers"]], x, cfg.remat)
    return unembed(rmsnorm(x, params["final_norm"]), params["embedding"])


def encdec_forward(params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return decode_train(params, cfg, tokens, encode(params, cfg, frames))


# -- serving ------------------------------------------------------------------


def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device="cuda") -> Dict[str, Any]:
    dtype = dtype or cfg.dtype
    dh, L, hkv = cfg.dh, cfg.n_layers, cfg.n_kv_heads

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "len": zeros(batch, dt=torch.int32),
        "k": zeros(L, batch, max_len, hkv, dh),
        "v": zeros(L, batch, max_len, hkv, dh),
        # cross K/V, filled at prefill from the encoder output
        "xk": zeros(L, batch, cfg.encoder_frames, hkv, dh),
        "xv": zeros(L, batch, cfg.encoder_frames, hkv, dh),
    }


def encdec_prefill(params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor, *,
                   max_len: Optional[int] = None):
    """Encode the audio and teacher-force the prompt; returns (last logits
    f32 [B, V], cache). ``max_len`` > S allocates the self-attention K/V
    that long, zero past the prompt; the cross K/V cover the frames."""
    enc_out = encode(params, cfg, frames)
    b, s = tokens.shape
    x = embed(params["embedding"], tokens, cfg.dtype)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    shape = (cfg.n_layers, b, max(s, max_len or s), cfg.n_kv_heads, cfg.dh)
    cache = {"len": torch.full((b,), s, dtype=torch.int32, device=x.device),
             "k": torch.zeros(shape, dtype=cfg.dtype, device=x.device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=x.device)}
    xks, xvs = [], []
    for i, lp in enumerate(params["dec_layers"]):
        x, (k, v), (xk, xv) = _dec_layer(cfg, lp, x, positions, enc_out=enc_out)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        xks.append(xk)
        xvs.append(xv)
    cache["xk"], cache["xv"] = torch.stack(xks), torch.stack(xvs)
    logits = unembed(rmsnorm(x[:, -1:], params["final_norm"]), params["embedding"])[:, 0]
    return logits, cache


def encdec_decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache):
    """One token [B] against the cache, written in place; returns (logits
    f32 [B, V], cache with the new ``len``). A full row raises
    ``ValueError`` (``decode.check_room``)."""
    new_len = cache["len"] + 1
    check_room(cache, new_len)
    positions = (new_len - 1)[:, None]
    x = embed(params["embedding"], token[:, None], cfg.dtype)
    for i, lp in enumerate(params["dec_layers"]):
        x, _, _ = _dec_layer(cfg, lp, x, positions, enc_kv=(cache["xk"][i], cache["xv"][i]),
                             kv_cache=(cache["k"][i], cache["v"][i]), cache_len=new_len)
    logits = unembed(rmsnorm(x, params["final_norm"]), params["embedding"])[:, 0]
    return logits, dict(cache, len=new_len)
