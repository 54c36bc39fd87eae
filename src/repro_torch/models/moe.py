"""Mixture-of-Experts layer: shared + routed experts, top-k routing,
capacity-based static dispatch, expert parallelism.

The counterpart of ``repro.models.moe``. Dispatch is the reference's
static-shape formulation: flatten the tokens, rank each (token, slot) pair
within its expert in token order, drop the pairs past the capacity, gather
the kept tokens into an [E, C, D] buffer, run every expert's SwiGLU as
batched products (``torch.bmm``, plain torch on every device: the reference
runs ``jnp`` einsums outside any Pallas kernel), and combine with the router
gates. Aux outputs: the Switch load-balancing loss, the router z-loss and
the dropped fraction of pairs.

Where the reference scatter-adds (``buf.at[...].add``, ``yt.at[flat_t].add``)
the port gathers, and so do the backward passes (``_Gather``): a kept pair
owns exactly one slot, so the dispatch is a gather of each slot's token, and
its gradient a gather of each pair's slot summed over the k slots in slot
order; the combine sums a token's k contributions in slot order as the
reference's scatter-add does, in the model's dtype. No float atomics, so the
card's results and gradients are the same from run to run. Routing ties go
to the lower expert index, as ``jax.lax.top_k`` breaks them (a stable
descending sort; ``torch.topk`` promises no order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import get_rules, shard_activation
from ..launch.mesh import canonical_device
from .layers import dense_init, init_mlp, mlp

AUX_KEYS = ("lb_loss", "z_loss", "dropped_frac")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int  # per-expert FFN width (fine-grained experts are narrow)
    n_shared_experts: int = 0
    d_ff_shared: Optional[int] = None  # defaults to d_ff_expert * n_shared
    capacity_factor: float = 1.25
    # serving path: capacity dropping would make decode outputs depend on the
    # batch composition — use a near-dropless factor there instead.
    serve_capacity_factor: float = 8.0
    router_noise: float = 0.0


def _expert_init(gen, shape, dtype: torch.dtype) -> torch.Tensor:
    """The reference's ``_dense_init`` of an [E, a, b] expert tensor
    (Normal(0, 1/E): its fan-in is ``shape[0]``), drawn one expert at a time
    in f32 and stored in ``dtype``, so that no f32 copy of the whole tensor
    exists (kimi's [384, 7168, 2048] would take 22.5 GB)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for i in range(shape[0]):
        out[i] = dense_init(gen, shape[1:], scale=shape[0] ** -0.5)
    return out


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The router stays f32 in every case: the reference reads it in f32."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    p: Dict[str, Any] = {
        "router": dense_init(gen, (d_model, e)),
        "experts": {
            "w_up": _expert_init(gen, (e, d_model, f), dtype),
            "w_gate": _expert_init(gen, (e, d_model, f), dtype),
            "w_down": _expert_init(gen, (e, f, d_model), dtype),
        },
    }
    if cfg.n_shared_experts > 0:
        d_sh = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared_experts
        p["shared"] = init_mlp(gen, d_model, d_sh, dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# routing, dispatch and combine
# ---------------------------------------------------------------------------


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` where an index equal to ``len(src)`` reads a zero row."""
    n = src.shape[0]
    rows = src[idx.clamp(max=max(n - 1, 0))]
    return torch.where((idx < n)[:, None], rows, rows.new_zeros(()))


def _fold(x: torch.Tensor) -> torch.Tensor:
    """x [N, k, D] summed over k in slot order, in x's dtype (the
    reference's scatter-add of a token's k contributions)."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc


class _Gather(torch.autograd.Function):
    """``out = src[idx]`` (``_take``) whose backward is a gather as well:
    ``dsrc[i]`` is the sum over j < ``fold`` of ``dout[inv[i * fold + j]]``
    (``_take`` again, then ``_fold``). ``inv`` is ``idx``'s inverse map:
    every row of ``out`` comes from one row of ``src``, and ``inv`` lists,
    for each row of ``src``, the ``fold`` rows of ``out`` it went to (or
    ``len(out)`` where it went nowhere)."""

    @staticmethod
    def forward(ctx, src, idx, inv, fold: int):
        ctx.save_for_backward(inv)
        ctx.fold, ctx.n = fold, src.shape[0]
        return _take(src, idx)

    @staticmethod
    def backward(ctx, dout):
        (inv,) = ctx.saved_tensors
        g = _take(dout.contiguous(), inv)
        if ctx.fold > 1:
            g = _fold(g.view(ctx.n, ctx.fold, -1))
        return g, None, None, None


@dataclasses.dataclass
class Routing:
    """One token group's routing at capacity ``cap``. Pair ``p`` is token
    ``p // k``'s ``p % k``-th choice; slot ``s`` is row ``s % cap`` of expert
    ``s // cap``'s buffer."""

    logits: torch.Tensor  # f32 [T, E]
    probs: torch.Tensor  # f32 [T, E]
    eidx: torch.Tensor  # long [T, k], best first
    gates: torch.Tensor  # f32 [T*k], normalized over a token's k choices
    keep: torch.Tensor  # bool [T*k]
    pair_slot: torch.Tensor  # long [T*k]: the pair's slot, E*cap where dropped
    slot_pair: torch.Tensor  # long [E*cap]: the slot's pair, T*k where empty
    cap: int


def _count(idx: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``idx`` (int64 [n]): an integer
    ``index_add_``, exact in any order. ``torch.bincount`` would read the
    largest index back to the host on the card, a sync each call."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).index_add_(0, idx, torch.ones_like(idx))


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt: torch.Tensor, router: torch.Tensor, cfg: MoEConfig, cap: int) -> Routing:
    """Router logits in f32, softmax, top-k, the gates renormalized; each
    pair's rank within its expert in token order (a stable sort by expert),
    kept below ``cap``."""
    e, k = cfg.n_experts, cfg.top_k
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat_e = eidx.reshape(-1)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)  # pairs grouped by expert, in token order
    counts = _count(flat_e, e)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(n, device=xt.device) - starts[flat_e[order]]
    keep = rank < cap
    pair_slot = torch.where(keep, flat_e * cap + rank, e * cap)
    r = torch.arange(cap, device=xt.device)
    filled = r[None, :] < counts[:, None]  # [E, cap]
    at = torch.clamp(starts[:, None] + r[None, :], max=n - 1)
    slot_pair = torch.where(filled, order[at], n).reshape(-1)
    return Routing(logits, probs, eidx, gates.reshape(-1), keep, pair_slot, slot_pair, cap)


def dispatch(xt: torch.Tensor, r: Routing, k: int) -> torch.Tensor:
    """xt [T, D] -> the experts' buffer [E*cap, D]: each filled slot holds its
    pair's token, an empty slot zeros."""
    slot_token = torch.where(r.slot_pair < r.keep.shape[0], r.slot_pair // k, xt.shape[0])
    return _Gather.apply(xt, slot_token, r.pair_slot, k)


def combine(out: torch.Tensor, r: Routing, k: int, dtype: torch.dtype) -> torch.Tensor:
    """The experts' outputs [E*cap, D] -> yt [T, D]: each kept pair's output
    times its gate (in ``dtype``), a token's k contributions summed in slot
    order; a dropped pair adds 0."""
    got = _Gather.apply(out, r.pair_slot, r.slot_pair, 1)  # [T*k, D]
    contrib = got * r.gates[:, None].to(dtype)
    return _fold(contrib.view(-1, k, contrib.shape[-1]))


def experts_ffn(w: Dict[str, torch.Tensor], buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU over its rows: buf [E, C, D] -> [E, C, D]."""
    h = torch.bmm(buf, w["w_gate"].to(buf.dtype))
    u = torch.bmm(buf, w["w_up"].to(buf.dtype))
    return torch.bmm(F.silu(h) * u, w["w_down"].to(buf.dtype))


def _stats(r: Routing, e: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(fraction of tokens whose first choice is each expert, mean router
    probability of each expert, z-loss, dropped fraction)."""
    t = r.eidx.shape[0]
    me = _count(r.eidx[:, 0], e).to(torch.float32) / t
    pe = r.probs.mean(dim=0)
    z = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2)
    dropped = 1.0 - r.keep.to(torch.float32).mean()
    return me, pe, z, dropped


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def moe_layer(p: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig,
              serving: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Entry point: the expert-parallel path (``moe_layer_ep``) when the
    sharding rules hold a mesh whose ``data`` axis divides the experts and
    the call is not serving, else the dense single-device formulation."""
    rules = get_rules()
    if (
        not serving
        and rules is not None
        and rules.mesh is not None
        and "data" in rules.mesh.axis_names
        and cfg.n_experts % rules.mesh.shape["data"] == 0
    ):
        return moe_layer_ep(p, x, cfg, rules)
    return moe_layer_dense(p, x, cfg, serving)


def capacity(t: int, cfg: MoEConfig, serving: bool = False) -> int:
    """Slots per expert for ``t`` tokens: the reference's float floor,
    ``int(min(t, max(1, (t*k*cf) // e)))``."""
    cf = cfg.serve_capacity_factor if serving else cfg.capacity_factor
    return int(min(t, max(1, (t * cfg.top_k * cf) // cfg.n_experts)))


def moe_layer_dense(p: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig,
                    serving: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (y [B, S, D], {"lb_loss", "z_loss", "dropped_frac"})."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    r = route(xt, p["router"], cfg, capacity(t, cfg, serving))
    buf = shard_activation(dispatch(xt, r, k).view(e, r.cap, d), "expert_buf")
    out = experts_ffn(p["experts"], buf)
    y = combine(out.reshape(e * r.cap, d), r, k, x.dtype).reshape(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    me, pe, z, dropped = _stats(r, e)
    return y, {"lb_loss": e * torch.sum(me * pe), "z_loss": z, "dropped_frac": dropped}


# ---------------------------------------------------------------------------
# expert parallelism over the mesh's data axis
# ---------------------------------------------------------------------------


def moe_layer_ep(p: Dict[str, Any], x: torch.Tensor, cfg: MoEConfig,
                 rules) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's expert-parallel schedule, single-controller over
    ``rules.mesh`` (as the sharded engine): the batch splits over the batch
    axes ("pod", "data"); each shard routes its own tokens at a capacity
    counted per source shard, ``cap_e``; data rank ``r`` holds experts
    [r·E/dp, (r+1)·E/dp). The all-to-all is an index shuffle: rank r's
    receive buffer stacks what every shard of its pod put in r's part of its
    send buffer, [E/dp, dp·cap_e, D]; the return trip gives each shard its
    pairs' outputs back in its own send layout. The model axis does not
    split the FFN width here: one controller computes it whole. Aux values
    are means over the data shards (of the first pod), as the reference's
    ``pmean`` before the product. A batch the batch axes cannot split goes
    dense. Every rank of the mesh must be the activations' device."""
    mesh = rules.mesh
    dp = mesh.shape["data"]
    batch_axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    bp = 1
    for a in batch_axes:
        bp *= mesh.shape[a]
    b, s, d = x.shape
    if b % bp != 0:
        return moe_layer_dense(p, x, cfg)
    dev = canonical_device(x.device)
    if any(canonical_device(r) != dev for r in mesh.devices.flat):
        raise ValueError(f"moe_layer_ep computes on the activations' device {dev}; the mesh has ranks on "
                         f"{sorted({str(r) for r in mesh.devices.flat})}")
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // dp
    t_loc = (b // bp) * s
    cap_e = int(max(1, (t_loc * k * cfg.capacity_factor) // e))
    xt = x.reshape(bp, t_loc, d)  # shard i = (pod i // dp, data rank i % dp)
    routes = [route(xt[i], p["router"], cfg, cap_e) for i in range(bp)]
    send = [dispatch(xt[i], routes[i], k).view(dp, e_loc, cap_e, d) for i in range(bp)]
    w = p["experts"]
    ys = []
    for pod in range(bp // dp):
        shards = range(pod * dp, (pod + 1) * dp)
        recv = []
        for rank in range(dp):
            buf = torch.stack([send[i][rank] for i in shards], dim=1).reshape(e_loc, dp * cap_e, d)
            w_r = {name: t[rank * e_loc:(rank + 1) * e_loc] for name, t in w.items()}
            recv.append(experts_ffn(w_r, buf).view(e_loc, dp, cap_e, d))
        for j, i in enumerate(shards):
            back = torch.stack([recv[rank][:, j] for rank in range(dp)], dim=0)  # [dp, E/dp, cap_e, D]
            ys.append(combine(back.reshape(e * cap_e, d), routes[i], k, x.dtype))
    y = torch.cat(ys, dim=0).reshape(b, s, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x)
    stats = [_stats(r, e) for r in routes[:dp]]
    me, pe, z, dropped = (torch.stack(col).mean(dim=0) for col in zip(*stats))
    return y, {"lb_loss": e * torch.sum(me * pe), "z_loss": z, "dropped_frac": dropped}
