"""Model API: init / loss / prefill / decode / cache / input_specs.

The counterpart of ``repro.models.api`` for every family: the decoder-only
ones (``transformer``, ``decode``) and encdec (``encdec``).
``input_specs``, ``init_cache_specs`` and ``params_specs`` are the dry-run's
shapes: the port's own tensors built by ``init_cache`` and ``init_model``
on the ``meta`` device, which allocates nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import decode as dec
from . import encdec as ed
from .layers import MetaGenerator
from .transformer import ModelConfig, init_lm, lm_forward, require_ported
from .tree import leaves, tree_map


def init_model(cfg: ModelConfig, gen: torch.Generator, *, masters: bool = False) -> Dict[str, Any]:
    """Random weights drawn from ``gen``, on its device; ``masters``: every
    leaf in f32 (training)."""
    require_ported(cfg)
    if cfg.family == "encdec":
        return ed.init_encdec(cfg, gen, masters=masters)
    return init_lm(cfg, gen, masters=masters)


def count_params(params) -> int:
    return sum(int(x.numel()) for x in leaves(params))


def params_to(tree, device):
    """The same weights with every leaf moved to ``device``."""
    return tree_map(lambda x: x.to(device), tree)


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict]:
    """Causal-LM cross entropy (+ the moe aux losses), the reference's
    formula: batch {"tokens", "labels"} int [B, S] (vlm: + "vision_embeds"
    [B, P, D], the loss over the text positions only; encdec: + "frames"
    [B, F, D]), a label < 0 ignored (not only -100); the mean over kept
    labels, divided by ``max(count, 1)`` so that an all-ignored batch gives
    0 (``F.cross_entropy(ignore_index=-100)`` would give NaN). Returns
    (total, {"ce_loss", "lb_loss", "z_loss", "dropped_frac"}), the aux values
    entering the total with the reference's weights (0 but for moe); encdec
    has no aux values and returns {"ce_loss"} alone, as the reference."""
    tokens, labels = batch["tokens"], batch["labels"]
    if cfg.family == "encdec":
        logits, aux = ed.encdec_forward(params, cfg, batch["frames"], tokens), {}
    elif cfg.family == "vlm":
        logits, aux = lm_forward(params, cfg, tokens, vision_embeds=batch["vision_embeds"])
        logits = logits[:, cfg.vision_patches:]
    else:
        logits, aux = lm_forward(params, cfg, tokens)
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).to(torch.int64)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = loss
    if aux:
        total = total + 0.01 * aux["lb_loss"] + 1e-4 * aux["z_loss"]
    return total, {"ce_loss": loss, **aux}


def serve_prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
                  max_len: Optional[int] = None):
    """batch {"tokens": int [B, S]} (vlm: + "vision_embeds" [B, P, D];
    encdec: + "frames" [B, F, D]) -> (last logits f32 [B, V], cache).
    ``max_len`` pads every family's K/V cache past the prompt to leave room
    for decoding (SSM states are O(1) and need no padding)."""
    if cfg.family == "encdec":
        return ed.encdec_prefill(params, cfg, batch["frames"], batch["tokens"], max_len=max_len)
    return dec.prefill(params, cfg, batch["tokens"], max_len=max_len,
                       vision_embeds=batch["vision_embeds"] if cfg.family == "vlm" else None)


def serve_decode(params, cfg: ModelConfig, token: torch.Tensor, cache):
    if cfg.family == "encdec":
        return ed.encdec_decode_step(params, cfg, token, cache)
    return dec.decode_step(params, cfg, token, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    require_ported(cfg)
    if cfg.family == "encdec":
        return ed.init_encdec_cache(cfg, batch, max_len, device=device)
    return dec.init_cache(cfg, batch, max_len, device=device)


# ---------------------------------------------------------------------------
# meta-device stand-ins for the dry-run
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, kind: str, *, batch: int, seq_len: int) -> Dict[str, Any]:
    """kind ∈ {train, prefill, decode}: the step's inputs as ``meta``
    tensors (shapes and dtypes, no allocation)."""
    require_ported(cfg)
    i32 = torch.int32

    def spec(*shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def extra():
        if cfg.family == "vlm":
            return {"vision_embeds": spec(batch, cfg.vision_patches, cfg.d_model, dtype=torch.float32)}
        if cfg.family == "encdec":
            return {"frames": spec(batch, cfg.encoder_frames, cfg.d_model, dtype=torch.float32)}
        return {}

    if kind == "train":
        return {"tokens": spec(batch, seq_len), "labels": spec(batch, seq_len), **extra()}
    if kind == "prefill":
        return {"tokens": spec(batch, seq_len), **extra()}
    if kind == "decode":
        return {"token": spec(batch), "cache": init_cache_specs(cfg, batch, seq_len)}
    raise ValueError(kind)


def init_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    """``init_cache`` on the meta device (no allocation)."""
    return init_cache(cfg, batch, max_len, device="meta")


def params_specs(cfg: ModelConfig):
    """The parameters as ``init_model(..., masters=True)`` builds them (f32,
    the reference's types), on the meta device (no allocation)."""
    return init_model(cfg, MetaGenerator(), masters=True)
