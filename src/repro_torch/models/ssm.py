"""Mamba2 (SSD, state-space duality) blocks, chunked.

The counterpart of ``repro.models.ssm``: the chunked SSD algorithm of Dao &
Gu 2024 (arXiv:2405.21060). The sequence is split into chunks; within a
chunk the SSD computation is a masked, decay-weighted attention-like
product, and across chunks a loop carries the [H, N, P] state (the
reference's ``lax.scan``). Decode is the SSM recurrence proper: the state
[B, H, N, P] is updated per token in O(1).

Shapes follow the Mamba2 convention: d_inner = expand * d_model split into
H heads of P = head_dim; B/C are per-group [N = d_state] (one group). The
pieces are plain torch ops on every device, as the reference's are ``jnp``
outside any Pallas kernel; the casts follow the reference's one for one.
The reference's four-operand einsums run here as pairwise products, so
their sums come in another order (within 1e-4 in f32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init, init_rmsnorm, rmsnorm


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_ssm(gen: torch.Generator, cfg: SSMConfig,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The projections in ``dtype``; ``conv_w``, ``A_log``, ``dt_bias``,
    ``D`` and ``norm`` in f32, as the reference stores and reads them."""
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    dev = gen.device
    # in_proj emits [z, x, B, C, dt]
    d_proj = 2 * di + 2 * n + h
    return {
        "in_proj": dense_init(gen, (cfg.d_model, d_proj), dtype=dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, di + 2 * n), scale=0.5),
        "A_log": torch.zeros((h,), dtype=torch.float32, device=dev),  # A = -exp(A_log) in (-inf, 0)
        "dt_bias": torch.full((h,), -2.0, dtype=torch.float32, device=dev),  # softplus(-2) ≈ 0.12
        "D": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": init_rmsnorm(di, dev),
        "out_proj": dense_init(gen, (di, cfg.d_model), dtype=dtype),
    }


def _split_proj(p, x: torch.Tensor, cfg: SSMConfig):
    di, n, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    proj = x @ p["in_proj"].to(x.dtype)  # [B, S, 2di + 2n + h]
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width W. xbc [B, S, C], w [W, C]; sums in f32,
    SiLU, cast back to xbc's type.

    state (decode): last W-1 inputs [B, W-1, C]; returns (out, new_state)."""
    bsz, s, c = xbc.shape
    wlen = w.shape[0]
    if state is None:
        pad = torch.zeros((bsz, wlen - 1, c), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)  # [B, S + W - 1, C]
    out = torch.zeros((bsz, s, c), dtype=torch.float32, device=xbc.device)
    for i in range(wlen):
        out = out + full[:, i:i + s].to(torch.float32) * w[i].to(torch.float32)
    new_state = full[:, full.shape[1] - (wlen - 1):]
    return F.silu(out).to(xbc.dtype), new_state


def ssd_chunked(
    xh: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]  (post-softplus)
    A: torch.Tensor,  # [H] negative
    Bm: torch.Tensor,  # [B, S, N]
    Cm: torch.Tensor,  # [B, S, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in f32. Returns (y [B, S, H, P], final_state [B, H, N, P])."""
    b, s, h, p_ = xh.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    sp = ((s + q - 1) // q) * q
    pad = sp - s
    if pad:  # zero steps at the end: dt = 0 leaves the state as it is
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = sp // q

    xh = xh.reshape(b, nc, q, h, p_).to(torch.float32)
    dt = dt.reshape(b, nc, q, h).to(torch.float32)
    Bm = Bm.reshape(b, nc, q, n).to(torch.float32)
    Cm = Cm.reshape(b, nc, q, n).to(torch.float32)

    dA = dt * A.to(torch.float32)  # [B, NC, Q, H] (negative increments)
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    seg_end = cum[:, :, -1:, :]  # [B, NC, 1, H]

    # ---- intra-chunk (block-diagonal) term ----------------------------------
    # L[i, j] = exp(cum_i - cum_j) for i >= j (decay from j to i), else 0. The
    # mask goes in before the exp (exp(-inf) = 0), so the masked entries give
    # 0 and a zero gradient, where exp of a large cum_i - cum_j would be inf.
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, NC, Q, Q, H]
    L = torch.exp(diff.masked_fill(~mask[None, None, :, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cm, Bm)  # [B, NC, Q, Q]
    w = cb[..., None] * L * dt[:, :, None, :, :]  # [B, NC, Q(i), Q(j), H]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xh)

    # ---- chunk summary states ------------------------------------------------
    # state contribution of chunk: Σ_j exp(seg_end - cum_j) dt_j B_j ⊗ x_j
    decay_to_end = torch.exp(seg_end - cum)  # [B, NC, Q, H]
    S_chunk = torch.einsum("bcjn,bcjhp->bchnp", Bm, xh * (decay_to_end * dt)[..., None])

    # ---- inter-chunk recurrence (a loop over the chunks) ---------------------
    seg = torch.exp(seg_end[:, :, 0, :])  # [B, NC, H] total chunk decay
    state = (init_state.to(torch.float32) if init_state is not None
             else torch.zeros((b, h, n, p_), dtype=torch.float32, device=xh.device))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * seg[:, c, :, None, None] + S_chunk[:, c]
    prev_states = torch.stack(prev, dim=1)  # [B, NC, H, N, P]

    # ---- inter-chunk output term ----------------------------------------------
    decay_from_start = torch.exp(cum)  # [B, NC, Q, H]
    y_inter = torch.einsum("bcin,bchnp->bcihp", Cm, prev_states) * decay_from_start[..., None]

    y = (y_intra + y_inter).reshape(b, sp, h, p_)[:, :s]
    return y, state


def ssm_block(
    p: Dict[str, Any],
    x: torch.Tensor,  # [B, S, D]
    cfg: SSMConfig,
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,  # decode: {"ssm", "conv"}
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full Mamba2 block. Without state: chunked SSD over the sequence.

    With state: single-token recurrent decode (x is [B, 1, D]). Returns
    (out [B, S, D] in x's type, {"ssm": f32 [B, H, N, P], "conv": [B, W-1,
    C] in x's type})."""
    b, s, _ = x.shape
    di, n, h, pdim = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    z, xbc, dt_raw = _split_proj(p, x, cfg)
    conv_state = state["conv"] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], conv_state)
    xs, Bm, Cm = torch.split(xbc, [di, n, n], dim=-1)
    xh = xs.reshape(b, s, h, pdim)
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].to(torch.float32))  # [H]

    if state is None:
        y, fin = ssd_chunked(xh, dt, A, Bm, Cm, cfg.chunk)
    else:
        # recurrence: h' = exp(dt A) h + dt * (B ⊗ x); y = C·h'
        s_prev = state["ssm"].to(torch.float32)  # [B, H, N, P]
        g = torch.exp(dt[:, 0, :] * A[None, :])  # [B, H]
        upd = (dt[:, 0, :, None, None] * Bm[:, 0].to(torch.float32)[:, None, :, None]
               * xh[:, 0].to(torch.float32)[:, :, None, :])
        fin = s_prev * g[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].to(torch.float32), fin)[:, None]

    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm(y, p["norm"])
    out = y @ p["out_proj"].to(x.dtype)
    return out, {"ssm": fin, "conv": new_conv}
