"""Decoder-only LM: the dense family (llama-like GQA: minicpm, qwen3 with
qk-norm, qwen1.5 with QKV bias, gemma3 with its local:global window
pattern), moe (deepseek, kimi: shared + routed experts behind leading dense
layers), ssm (mamba2: pure SSD stacks), hybrid (zamba2: groups of SSD
layers, each group followed by one weight-shared attention block with its
own KV per use) and vlm (internvl2: precomputed patch embeddings prepended
to the tokens). The encdec family (whisper) is ``encdec.py``.

The counterpart of ``repro.models.transformer``. Parameters are a plain
dict: ``embedding`` (f32 [V, D]), ``final_norm``, optional ``lm_head``,
``layers``, a list of per-layer dicts (dense and vlm: ``{"attn_norm",
"attn", "mlp_norm", "mlp"}``; moe: ``{"attn_norm", "attn", "mlp_norm",
"moe"}``; ssm and hybrid: ``{"norm", "ssm"}``), for moe ``dense_layers``,
the ``moe_first_dense`` leading dense layers, and for hybrid
``shared_attn``, one dense-layer dict applied after every group. The
reference stacks the layers on a leading axis and scans; here a Python loop
walks the list. Under grad with ``cfg.remat`` each layer, and each hybrid
group with its shared block, runs through ``torch.utils.checkpoint``, as
the reference's ``jax.checkpoint`` over the scanned body.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .attention import AttnConfig, attention_block, init_attention
from .layers import (embed, embed_scale, init_embedding, init_mlp, init_rmsnorm, mlp, rmsnorm,
                     unembed)
from .moe import AUX_KEYS, MoEConfig, init_moe, moe_layer
from .ssm import SSMConfig, init_ssm, ssm_block

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
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
    moe: Optional[MoEConfig] = None
    moe_first_dense: int = 0  # moe: the leading dense layers
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0  # zamba2: the shared attention block after every k ssm layers
    # enc-dec (whisper): see encdec.py
    encoder_layers: int = 0
    encoder_frames: int = 0
    # vlm: number of stub patch embeddings prepended
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

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def n_groups(self) -> int:
        """hybrid: the groups of ``hybrid_attn_every`` ssm layers, each
        followed by the shared attention block."""
        return self.n_layers // self.hybrid_attn_every

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


def require_ported(cfg: ModelConfig) -> None:
    """Every family of the reference runs in the port; an unknown family, or
    a hybrid whose layers do not make whole groups, raises ``ValueError``."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the families are {', '.join(FAMILIES)}")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid_attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of {cfg.hybrid_attn_every}")


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


def init_moe_layer(gen: torch.Generator, cfg: ModelConfig,
                   dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    dtype = dtype or cfg.dtype
    return {
        "attn_norm": init_rmsnorm(cfg.d_model, gen.device),
        "attn": init_attention(gen, cfg.attn_cfg(), dtype=dtype),
        "mlp_norm": init_rmsnorm(cfg.d_model, gen.device),
        "moe": init_moe(gen, cfg.d_model, cfg.moe, dtype=dtype),
    }


def init_lm(cfg: ModelConfig, gen: torch.Generator, *, masters: bool = False) -> Dict[str, Any]:
    """Random weights on ``gen``'s device (the draws differ from the
    reference's ``jax.random``; ``convert.params_from_jax`` carries the
    reference's weights across). Matmul weights in ``cfg.dtype`` for
    serving (a moe router stays f32); with ``masters`` every leaf in f32, as
    the reference keeps them for training (the layers cast per use). The
    encdec family's weights are ``encdec.init_encdec``'s."""
    require_ported(cfg)
    if cfg.family == "encdec":
        raise ValueError(f"init_lm does not handle family {cfg.family!r} (encdec.init_encdec does)")
    params: Dict[str, Any] = {
        "embedding": init_embedding(gen, cfg.vocab, cfg.d_model),
        "final_norm": init_rmsnorm(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_embedding(gen, cfg.vocab, cfg.d_model)
    dtype = torch.float32 if masters else cfg.dtype
    if cfg.family in ("dense", "vlm"):
        params["layers"] = [init_dense_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)]
        return params
    if cfg.family == "moe":
        nd = cfg.moe_first_dense
        if nd:
            params["dense_layers"] = [init_dense_layer(gen, cfg, dtype) for _ in range(nd)]
        params["layers"] = [init_moe_layer(gen, cfg, dtype) for _ in range(cfg.n_layers - nd)]
        return params
    params["layers"] = [{"norm": init_rmsnorm(cfg.d_model, gen.device), "ssm": init_ssm(gen, cfg.ssm, dtype)}
                        for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = init_dense_layer(gen, cfg, dtype)
    return params


# ---------------------------------------------------------------------------
# layer body and the pieces around the layers
# ---------------------------------------------------------------------------


def _attend(cfg: ModelConfig, lp, x, positions, window: int, cache, cache_len):
    """x plus the layer's pre-norm attention; returns (x, (k, v))."""
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
    return x + h, new_cache


def dense_body(cfg: ModelConfig, lp, x, positions, window: int, cache=None, cache_len=None):
    """One pre-norm layer: attention then SwiGLU MLP. Returns (x, (k, v))."""
    x, new_cache = _attend(cfg, lp, x, positions, window, cache, cache_len)
    return x + mlp(lp["mlp"], rmsnorm(x, lp["mlp_norm"])), new_cache


def moe_body(cfg: ModelConfig, lp, x, positions, window: int, cache=None, cache_len=None):
    """One pre-norm moe layer: attention then the experts. The experts run
    at the serving capacity factor when a cache is given (decode), else at
    the training one (training, scoring and prefill), as the reference's
    ``serving=cache is not None``. Returns (x, (k, v), aux)."""
    x, new_cache = _attend(cfg, lp, x, positions, window, cache, cache_len)
    y, aux = moe_layer(lp["moe"], rmsnorm(x, lp["mlp_norm"]), cfg.moe, serving=cache is not None)
    return x + y, new_cache, aux


def ssm_body(cfg: ModelConfig, lp, x, state=None):
    """One pre-norm SSD layer. Returns (x, {"ssm", "conv"})."""
    h, new_state = ssm_block(lp["ssm"], rmsnorm(x, lp["norm"]), cfg.ssm, state=state)
    return x + h, new_state


def groups(cfg: ModelConfig, layers: List[Any]) -> List[List[Any]]:
    """hybrid: the per-layer list cut into ``n_groups`` groups of
    ``hybrid_attn_every`` (the reference's ``reshape((G, E) + ...)``)."""
    e = cfg.hybrid_attn_every
    return [layers[i * e:(i + 1) * e] for i in range(cfg.n_groups)]


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor,
                 vision_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tokens' embeddings [B, S, D] in ``cfg.dtype``; with
    ``vision_embeds`` [B, P, D] (vlm) those first, cast: [B, P + S, D]."""
    x = embed(params["embedding"], tokens, cfg.dtype)
    if cfg.embed_scale:
        x = x * embed_scale(cfg.d_model, cfg.dtype)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(cfg.dtype), x], dim=1)
    return x


def layer_plan(params, cfg: ModelConfig):
    """(body, layer params, window) of every attention layer in order
    (dense, vlm and moe): a moe model's leading dense layers, then its moe
    layers; ``body`` is ``dense_body`` or ``moe_body``."""
    windows = cfg.layer_windows()
    nd = cfg.moe_first_dense if cfg.family == "moe" else 0
    body = moe_body if cfg.family == "moe" else dense_body
    return ([(dense_body, lp, w) for lp, w in zip(params.get("dense_layers", [])[:nd], windows[:nd])]
            + [(body, lp, w) for lp, w in zip(params["layers"], windows[nd:])])


def logits_of(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"])
    head = params["embedding"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, head)


# ---------------------------------------------------------------------------
# forward (scoring): full sequence, no cache
# ---------------------------------------------------------------------------


def _layers(params, cfg: ModelConfig, x: torch.Tensor, *, remat: bool):
    """Every layer over x [B, S, D]; returns (x, the moe layers' aux values
    summed in layer order, f32, zero for the other families). With
    ``remat`` (and grad enabled) each region (a dense, moe or ssm layer; a
    hybrid group of ssm layers with the shared block after it) is a
    ``torch.utils.checkpoint`` region: its activations are recomputed in
    the backward pass, so only the region inputs stay alive."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.family in ("dense", "vlm", "moe"):
        def region(body, lp, w):
            def fn(x):
                out = body(cfg, lp, x, positions, w)
                return out[0], (out[2] if body is moe_body else {})
            return fn

        regions = [region(body, lp, w) for body, lp, w in layer_plan(params, cfg)]
    elif cfg.family == "ssm":
        regions = [lambda x, lp=lp: (ssm_body(cfg, lp, x)[0], {}) for lp in params["layers"]]
    elif cfg.family == "hybrid":
        def group(x, glp):
            for lp in glp:
                x, _ = ssm_body(cfg, lp, x)
            return dense_body(cfg, params["shared_attn"], x, positions, 0)[0], {}

        regions = [lambda x, glp=glp: group(x, glp) for glp in groups(cfg, params["layers"])]
    else:
        raise ValueError(cfg.family)
    remat = remat and torch.is_grad_enabled()
    aux = {key: torch.zeros((), dtype=torch.float32, device=x.device) for key in AUX_KEYS}
    for fn in regions:
        x, a = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        for key in a:
            aux[key] = aux[key] + a[key]
    return x, aux


def lm_forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor, *,
               vision_embeds: Optional[torch.Tensor] = None):
    """tokens int [B, S] (vlm: after ``vision_embeds`` [B, P, D]) ->
    (logits f32 [B, S(+P), V], aux losses {"lb_loss", "z_loss",
    "dropped_frac"}, each summed over the moe layers; 0 for the other
    families). The encdec family raises ``ValueError``, as in the reference
    (``encdec.encdec_forward`` is its forward)."""
    require_ported(cfg)
    if cfg.family == "encdec":
        raise ValueError(cfg.family)
    x, aux = _layers(params, cfg, embed_tokens(params, cfg, tokens, vision_embeds), remat=cfg.remat)
    return logits_of(params, cfg, x), aux


@torch.no_grad()
def lm_hidden_embed(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Mean-pooled final hidden state, f32 [B, D]: the entity-embedding
    producer of the HQI integration (models emit vectors; HQI indexes them).
    As in the reference, the embedding is not scaled by ``sqrt(d)`` here
    even where ``cfg.embed_scale`` is set, and a vlm takes the dense path
    without patches. For moe, ssm and hybrid the reference returns the
    logits' mean over the sequence, f32 [B, V], and so does this (ROADMAP.md
    §3); encdec raises ``ValueError`` there, as the reference's
    ``lm_forward`` does. Builds no autograd graph."""
    require_ported(cfg)
    if cfg.family not in ("dense", "vlm"):
        return lm_forward(params, cfg, tokens)[0].mean(dim=1)
    x, _ = _layers(params, cfg, embed(params["embedding"], tokens, cfg.dtype), remat=False)
    x = rmsnorm(x, params["final_norm"])
    return x.mean(dim=1).to(torch.float32)
