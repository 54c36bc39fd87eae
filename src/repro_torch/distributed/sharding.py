"""Logical-axis sharding rules -> mesh axes (DP / FSDP / TP / EP) — the
counterpart of ``repro.distributed.sharding``.

Parameters are matched by path patterns, and the mapping from logical axes
to mesh axes is a per-run table, as in the reference. The port is
single-controller over ``launch.mesh.Mesh`` (no ``jax.sharding``), so:

  * ``param_spec_for`` and ``tree_param_specs`` return a tuple of mesh axes
    per dim (an axis name, a tuple of names, or None) where the reference
    returns a ``PartitionSpec`` of the same entries;
  * ``shard_activation`` returns its input unchanged: one controller has no
    sharding constraint to place;
  * the reference's ``shard_map_compat`` and ``tree_shardings`` have no
    counterpart;
  * the port's layer leaves are per layer (``params/layers/<i>/attn/wq``),
    with no stacked ``[L, ...]`` dim, so a leaf's spec is the reference's
    without its first entry; the expert leaves are ``[E, D, F]``;
  * only the rules a ported model's leaves reach are kept: the reference's
    ``OPT`` switches (``set_opt``, ``set_all_opt``), its FSDP placement on
    the stacked dim (``fsdp_stacked``) and its ``seq`` axis steer code or
    leaves the port does not have, so they have no counterpart. The
    ``expert`` axis resolves as the reference's default
    (``OPT["moe_ep_data"]`` on) resolves it: to "data", where
    ``models.moe.moe_layer_ep`` puts the experts.

Conventions (mesh axes: optional "pod", "data", "model"):
  batch        -> ("pod", "data")     activations' batch dim
  embed        -> None (replicated) or "data" under FSDP for params
  heads/mlp/kv -> "model"             tensor parallel param dims
  expert       -> "data"              expert parallel (with TP over the expert FFN)
  vocab        -> "model"
"""
from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Optional, Tuple

from ..launch.mesh import Mesh
from ..models.tree import path_key

_STATE = threading.local()

Spec = Tuple[Any, ...]


@dataclasses.dataclass
class ShardingRules:
    """How logical dims map to mesh axes for this run."""

    batch: Any = ("pod", "data")  # tuple = nested mapping over multiple axes
    heads: Any = "model"
    kv: Any = "model"
    mlp: Any = "model"
    # EP axis: None resolves to "data" (the reference's default): experts
    # stationary per data shard, tokens moved by the all-to-all
    expert: Any = None
    vocab: Any = "model"
    embed: Any = None  # "data" => FSDP: shard params' embed dim over data
    fsdp: bool = False
    mesh: Optional[Mesh] = None

    def axis(self, name: Optional[str]):
        if name is None:
            return None
        v = getattr(self, name)
        if name == "expert" and v is None:
            v = "data"
        if v is None:
            return None
        if isinstance(v, tuple):
            # only keep axes that exist in the mesh
            if self.mesh is None:
                return v
            kept = tuple(a for a in v if a in self.mesh.axis_names)
            return kept if kept else None
        if self.mesh is not None and v not in self.mesh.axis_names:
            return None
        return v


def set_rules(rules: Optional[ShardingRules]) -> None:
    _STATE.rules = rules


def get_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


class use_rules:
    def __init__(self, rules: Optional[ShardingRules]):
        self.rules = rules

    def __enter__(self):
        self.prev = get_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self.prev)


# kind -> logical dim names of the trailing axes, as the reference's table
ACTIVATION_SPECS = {
    "batch_seq": ("batch", "seq"),  # e.g. tokens [B, S]
    "hidden": ("batch", "seq", None),  # [B, S, D]
    "hidden_sp": ("batch", "seq", None),
    "mlp": ("batch", "seq", "mlp"),  # [B, S, F]
    "heads": ("batch", "seq", "heads", None),  # [B, S, H, Dh]
    "kv": ("batch", "seq", "kv", None),
    "kv_cache": ("batch", None, "kv", None),  # [B, T, Hkv, Dh]
    "logits": ("batch", "seq", "vocab"),
    "expert_buf": ("expert", None, None),  # [E, C, D]
}


def shard_activation(x, kind: str):
    """The reference annotates an intermediate with its logical sharding
    (``ACTIVATION_SPECS``: an unknown kind raises ``KeyError``); a single
    controller places nothing, so ``x`` comes back as it is."""
    ACTIVATION_SPECS[kind]
    return x


# -- parameter shardings ------------------------------------------------------

# path-pattern -> logical names per dim (matched right-aligned to the shape;
# leading dims are replicated). First match wins.
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"router", ("embed", None)),  # router stays small; replicate experts dim
    # experts: EP over the expert dim + TP over the expert-ffn dim
    (r"experts?.*w_(up|gate)", ("expert", None, "mlp")),
    (r"experts?.*w_down", ("expert", "mlp", None)),
    (r"w_(up|gate)", ("embed", "mlp")),
    (r"w_down", ("mlp", "embed")),
    (r"(wq|w_q)", ("embed", "heads")),
    (r"(wk|w_k|wv|w_v)", ("embed", "kv")),
    (r"(wo|w_o)", ("heads", "embed")),
    (r"(bq)", ("heads",)),
    (r"(bk|bv)", ("kv",)),
    (r"embedding|unembed|lm_head", ("vocab", "embed")),
    (r"in_proj", ("embed", "mlp")),  # ssm projections: tp over inner dim
    (r"out_proj", ("mlp", "embed")),
    (r"conv", (None, "mlp")),
    (r".*", (None,)),  # default: replicate (norm scales, A_log, dt_bias, ...)
)


def _axes_size(rules: ShardingRules, axis) -> int:
    if axis is None or rules.mesh is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= rules.mesh.shape[a]
        return out
    return rules.mesh.shape[axis]


def _sanitize(axes, shape, rules: ShardingRules):
    """Drop mesh axes that don't evenly divide their dim and duplicate
    mesh-axis uses (keep the first occurrence)."""
    out = []
    seen = set()
    for a, d in zip(axes, shape):
        ok = a is not None and d % _axes_size(rules, a) == 0
        names = a if isinstance(a, tuple) else (a,)
        if ok and any(n in seen for n in names):
            ok = False
        if ok:
            seen.update(names)
        out.append(a if ok else None)
    return out


def param_spec_for(path: str, shape: Tuple[int, ...], rules: ShardingRules) -> Spec:
    """The mesh axes of each dim of the leaf at ``path`` ("/"-joined keys)."""
    ndim = len(shape)
    for pat, names in PARAM_RULES:
        if re.search(pat, path):
            names = tuple(names)
            if len(names) > ndim:
                names = names[-ndim:] if ndim > 0 else ()
            pad = (None,) * (ndim - len(names))
            axes = _sanitize([rules.axis(n) for n in pad + names], shape, rules)
            # FSDP / ZeRO: shard one remaining replicated dim over the batch
            # axes (pod, data), preferring the second-to-last dim (embed for
            # matmuls)
            if rules.fsdp and rules.mesh is not None and "data" in rules.mesh.axis_names:
                batch_ax = rules.axis("batch") or "data"
                used = set()
                for a in axes:
                    used.update(a if isinstance(a, tuple) else (a,))
                b_names = batch_ax if isinstance(batch_ax, tuple) else (batch_ax,)
                if not any(n in used for n in b_names):
                    for i in list(range(ndim - 2, -1, -1)) + ([ndim - 1] if ndim else []):
                        if axes[i] is None and shape[i] % _axes_size(rules, batch_ax) == 0:
                            axes[i] = batch_ax
                            break
            return tuple(axes)
    return ()


def tree_param_specs(params: Any, rules: ShardingRules) -> Any:
    """A tree of specs matching ``params`` (tensors, or anything with a
    ``shape``): each leaf's ``param_spec_for`` at its path."""

    def visit(tree, path):
        if isinstance(tree, dict):
            return {k: visit(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(visit(v, path + (i,)) for i, v in enumerate(tree))
        return param_spec_for(path_key(path), tuple(tree.shape), rules)

    return visit(params, ())
