"""Decoder-only LM, dense family (llama-like GQA: minicpm, qwen3 with
qk-norm, qwen1.5 with QKV bias, gemma3 with its local:global window
pattern).

The counterpart of ``repro.models.transformer``. Parameters are a plain
dict: ``embedding`` (f32 [V, D]), ``final_norm``, optional ``lm_head``, and
``layers``, a list of per-layer dicts (the reference stacks them on a
leading axis and scans; here a Python loop walks the list; under grad with
``cfg.remat`` each layer runs through ``torch.utils.checkpoint``, as the
reference's ``jax.checkpoint`` over the scanned layer body). The moe, ssm,
hybrid, vlm and encdec families are not ported yet (ROADMAP.md §1, the rest
of the LM scaffolding):
their entry points raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import AttnConfig, attention_block, init_attention
from .layers import (embed, embed_scale, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm,
                     unembed)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm (only dense runs here)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # cycle of per-layer sliding windows; 0 = global. gemma3: (w,w,w,w,w,0)
    window_pattern: Optional[Tuple[int, ...]] = None
    moe: Optional[Any] = None  # the reference's MoEConfig (family not ported)
    moe_first_dense: int = 0
    ssm: Optional[Any] = None  # the reference's SSMConfig (family not ported)
    hybrid_attn_every: int = 0
    encoder_layers: int = 0
    encoder_frames: int = 0
    vision_patches: int = 0
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma-style sqrt(d) embedding scaling
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True  # recompute each layer in the backward pass (training); serving ignores it
    q_chunk: int = 1024  # chunks of the plain attention (CPU); the kernel tiles by 64
    kv_chunk: int = 1024

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self, causal: bool = True) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim,
            qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias,
            rope_theta=self.rope_theta,
            causal=causal,
        )

    def layer_windows(self) -> List[int]:
        """Sliding window per layer (0 = global)."""
        if self.window_pattern is None:
            return [0] * self.n_layers
        pat = list(self.window_pattern)
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return [int(w) for w in (pat * reps)[: self.n_layers]]


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch yet; the port "
            f"runs the dense family (ROADMAP.md §1, the rest of the LM scaffolding)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_dense_layer(gen: torch.Generator, cfg: ModelConfig,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    dtype = dtype or cfg.dtype
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, gen.device),
        "attn": init_attention(gen, cfg.attn_cfg(), dtype=dtype),
        "mlp_norm": init_rmsnorm(cfg.d_model, gen.device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dtype),
    }


def init_lm(cfg: ModelConfig, gen: torch.Generator, *, masters: bool = False) -> Dict[str, Any]:
    """Random weights on ``gen``'s device (the draws differ from the
    reference's ``jax.random``; ``convert.params_from_jax`` carries the
    reference's weights across). Matmul weights in ``cfg.dtype`` for
    serving; with ``masters`` every leaf in f32, as the reference keeps
    them for training (the layers cast per use)."""
    require_dense(cfg)
    params: Dict[str, Any] = {
        "embedding": init_embedding(gen, cfg.vocab, cfg.d_model),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab, cfg.d_model)
    dtype = torch.float32 if masters else cfg.dtype
    params["layers"] = [init_dense_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# layer body and the pieces around the layers
# ---------------------------------------------------------------------------


def dense_body(cfg: ModelConfig, lp, x, positions, window: int, cache=None, cache_len=None):
    """One pre-norm layer: attention then SwiGLU MLP. Returns (x, (k, v))."""
    h, new_cache = attention_block(
        lp["attn"],
        rmsnorm(x, lp["attn_norm"]),
        cfg.attn_cfg(),
        positions=positions,
        window=window,
        kv_cache=cache,
        cache_len=cache_len,
        q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk,
    )
    x = x + h
    x = x + mlp(lp["mlp"], rmsnorm(x, lp["mlp_norm"]))
    return x, new_cache


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = embed(params["embedding"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * embed_scale(cfg.d_model, cfg.dtype)
    return x


def logits_of(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"])
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, head)


# ---------------------------------------------------------------------------
# forward (scoring): full sequence, no cache
# ---------------------------------------------------------------------------


def _layers(params, cfg: ModelConfig, x: torch.Tensor, *, remat: bool) -> torch.Tensor:
    """Every layer over x [B, S, D]. With ``remat`` (and grad enabled) each
    layer is a ``torch.utils.checkpoint`` region: its activations are
    recomputed in the backward pass, so only the layer inputs stay alive."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    remat = remat and torch.is_grad_enabled()
    for lp, w in zip(params["layers"], cfg.layer_windows()):
        if remat:
            x = checkpoint(lambda x, lp=lp, w=w: dense_body(cfg, lp, x, positions, w)[0], x,
                           use_reentrant=False)
        else:
            x, _ = dense_body(cfg, lp, x, positions, w)
    return x


def lm_forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor):
    """tokens int [B, S] -> (logits f32 [B, S, V], aux losses). The dense
    family has no auxiliary losses; the dict keeps the reference's keys."""
    require_dense(cfg)
    x = _layers(params, cfg, embed_tokens(params, cfg, tokens), remat=cfg.remat)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero, "dropped_frac": zero}
    return logits_of(params, cfg, x), aux


@torch.no_grad()
def lm_hidden_embed(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Mean-pooled final hidden state, f32 [B, D]: the entity-embedding
    producer of the HQI integration (models emit vectors; HQI indexes them).
    As in the reference, the embedding is not scaled by ``sqrt(d)`` here
    even where ``cfg.embed_scale`` is set. Builds no autograd graph."""
    require_dense(cfg)
    x = _layers(params, cfg, embed(params["embedding"], tokens, cfg.dtype), remat=False)
    x = rmsnorm(x, params["final_norm"])
    return x.mean(dim=1).to(torch.float32)
