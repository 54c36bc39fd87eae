"""Multi-pod dry run: count every (arch × shape × mesh) cell on ``meta``
tensors — the counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices and reads the per-device HLO. The port has no compiler to ask,
so for every cell it:

    1. builds the production mesh as placeholders: 16×16 ("data", "model")
       single-pod, 2×16×16 ("pod", "data", "model") multi-pod, every
       position on the ``meta`` device (``make_test_mesh(..., device="meta")``:
       no flags, no process of its own);
    2. builds the step (the train step, prefill, decode, or the hqi roofline
       step) from the port's ``api.params_specs`` / ``input_specs`` /
       ``init_cache_specs``, ``optimizer.init_opt`` and ``make_train_step``
       (or ``api.serve_prefill`` / ``serve_decode``), all on meta;
    3. runs it once, eagerly, under ``op_cost.OpCounter`` and the cell's
       sharding rules: a run to its end proves the shapes compose, as the
       reference's compile does;
    4. records per-device FLOPs (by type), HBM bytes and the peak of live
       bytes (``op_cost``), collective bytes by kind
       (``roofline.collective_bytes``), argument bytes from the leaves'
       axis tuples, and the h100 roofline terms into
       ``dryrun_results_torch.json`` at the repo root (incremental: a re-run
       skips finished cells).

The rules are the reference's defaults: FSDP from 5e9 parameters, the
batch over the largest prefix of (pod, data) that divides it, the caches'
kv-heads (else head_dim) on "model" and their batch on the batch axes
(``kv_cache_time_shard`` off), 8 training microbatches, and serving on the
f32 parameters (``serve_bf16`` off). The reference's ``fsdp_stacked`` and
``--baseline`` have no counterpart (ROADMAP.md §3).

Usage:
    python -m repro_torch.launch.dryrun                     # all cells
    python -m repro_torch.launch.dryrun --arch qwen3-32b    # one arch
    python -m repro_torch.launch.dryrun --arch hqi-search   # the paper's step
    python -m repro_torch.launch.dryrun --shape train_4k --mesh single --out results.json
    python -m repro_torch.launch.dryrun --cell mamba2-130m:decode_32k --cell hqi-search:hqi_100m_online4k
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..configs import ARCHS, get_config, optimizer_for
from ..configs.shapes import SHAPES, shapes_for
from ..core.distributed import make_roofline_search_step, roofline_search_specs
from ..distributed.sharding import ShardingRules, tree_param_specs, use_rules
from ..models import api
from ..models.transformer import ModelConfig
from ..models.tree import leaves_with_paths, path_key
from ..train.optimizer import OptConfig, init_opt
from ..train.train_step import TrainConfig, make_train_step
from . import op_cost
from . import roofline as rl
from .mesh import make_test_mesh

RESULTS_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..", "dryrun_results_torch.json")

# FSDP (param/optimizer-state sharding over data) for models too big for pure TP.
FSDP_MIN_PARAMS = 5e9
# microbatches for train cells: bound activation memory at 4k×256.
TRAIN_MICROBATCHES = {"default": 8}
# the H100's memory, 80 GB (decimal: the card holds 85.0e9 bytes)
DEVICE_BYTES = 80e9
HQI_K = 10

HQI_SEARCH_SHAPES = {
    # the paper's step: N DB vectors × d, M queries per batch
    "hqi_100m_batch64k": dict(n=100_000_000, d=128, m=65_536),
    "hqi_100m_online4k": dict(n=100_000_000, d=128, m=4_096),
}

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
}


def production_mesh(multi_pod: bool):
    """The production mesh's shape and axes, every position on ``meta``."""
    shape, axes = MESHES["multi" if multi_pod else "single"]
    return make_test_mesh(shape, axes, device="meta")


def _rules_for(cfg: ModelConfig, mesh) -> ShardingRules:
    return ShardingRules(mesh=mesh, fsdp=rl.total_params(cfg) >= FSDP_MIN_PARAMS)


def _effective_batch_axes(mesh, batch_size: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) that divides the batch; () = replicate."""
    baxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    while baxes:
        if batch_size % int(np.prod([mesh.shape[a] for a in baxes])) == 0:
            return baxes
        baxes = baxes[1:]
    return ()


def _batch_specs(mesh, batch_tree, batch_size: int) -> Dict[str, tuple]:
    """Each batch leaf's axis tuple: dim 0 over the effective batch axes."""
    b = _effective_batch_axes(mesh, batch_size) or None
    return {k: (b,) + (None,) * (t.dim() - 1) for k, t in batch_tree.items()}


def _cache_specs(mesh, cache_tree, batch_size: int) -> Dict[str, tuple]:
    """KV caches [L, B, T, Hkv, dh]: batch over the batch axes, "model" on
    kv-heads if it divides them, else head_dim (the reference's placement
    with ``kv_cache_time_shard`` off). SSM states: batch over the batch
    axes, "model" on the first of the two dims after it it divides; conv
    windows: "model" on the channel dim."""
    baxes = _effective_batch_axes(mesh, batch_size) or None
    msize = mesh.shape["model"]

    def place_model(shape, axes, prefs):
        for i in prefs:
            if shape[i] % msize == 0:
                axes[i] = "model"
                break
        return tuple(axes)

    out = {}
    for key, t in cache_tree.items():
        nd, shape = t.dim(), tuple(t.shape)
        axes = [None] * nd
        if key == "len":
            out[key] = (baxes,)
        elif key in ("k", "v", "xk", "xv"):
            axes[1] = baxes
            out[key] = place_model(shape, axes, (3, 4))
        elif key == "ssm":
            b_i = 1 if nd == 5 else 2
            axes[b_i] = baxes
            out[key] = place_model(shape, axes, (b_i + 1, b_i + 2))
        elif key == "conv":
            b_i = 1 if nd == 4 else 2
            axes[b_i] = baxes
            out[key] = place_model(shape, axes, (nd - 1,))
        else:
            out[key] = tuple(axes)
    return out


def _shards(mesh, spec) -> int:
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                n *= int(mesh.shape[a])
    return n


def _spec_leaves(tree, specs) -> List[Tuple[torch.Tensor, tuple]]:
    """(leaf, axis tuple) pairs of a tree and its tree of axis tuples."""
    spec_of = {}

    def walk(s, path):
        if isinstance(s, dict):
            for k, v in s.items():
                walk(v, path + (k,))
        elif isinstance(s, list):
            for i, v in enumerate(s):
                walk(v, path + (i,))
        else:
            spec_of[path_key(path)] = s

    walk(specs, ())
    return [(t, spec_of[path_key(p)]) for p, t in leaves_with_paths(tree)]


def _argument_bytes(mesh, pairs) -> float:
    return float(sum(t.numel() * t.element_size() / _shards(mesh, sp) for t, sp in pairs))


def _registered(mesh, pairs):
    """``OpCounter.register`` arguments: each sharded leaf with the product
    of its axes."""
    return [([t], _shards(mesh, sp)) for t, sp in pairs]


def count_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict[str, Any]:
    """Build and count one cell (module docstring); the result row."""
    t0 = time.time()
    mesh = production_mesh(multi_pod)
    chips = int(np.prod(list(mesh.shape.values())))
    h100 = rl.hardware("h100")

    if arch == "hqi-search":
        spec = HQI_SEARCH_SHAPES[shape_name]
        step = make_roofline_search_step(mesh, k=HQI_K, metric="ip")
        tensors, axes = roofline_search_specs(mesh, **spec)
        _, cost = op_cost.count(step, *tensors, chips=chips)
        coll = rl.collective_bytes("hqi-search", mesh.shape, m=spec["m"], k=HQI_K)
        terms = rl.RooflineTerms(
            flops_per_dev=cost.flops, bytes_per_dev=cost.bytes,
            coll_bytes_per_dev=float(sum(coll.values())), coll_breakdown=coll,
            # the useful work is 2·N·d·M: one product per (query, row) pair
            model_flops=2.0 * spec["n"] * spec["m"] * spec["d"], chips=chips,
            hardware=h100, flops_by_dtype=cost.flops_by_dtype)
        return _result(arch, shape_name, multi_pod, terms, cost,
                       _argument_bytes(mesh, list(zip(tensors, axes))), t0, chips)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mb = TRAIN_MICROBATCHES.get(arch, TRAIN_MICROBATCHES["default"]) if shape.kind == "train" else 1
    terms, cost, argument_bytes = count_lm(
        cfg, shape.kind, mesh, batch=shape.global_batch, seq_len=shape.seq_len, microbatches=mb,
        optimizer=optimizer_for(arch))
    return _result(arch, shape_name, multi_pod, terms, cost, argument_bytes, t0, chips)


def count_lm(cfg: ModelConfig, kind: str, mesh, *, batch: int, seq_len: int, microbatches: int = 1,
             optimizer: str = "adamw") -> Tuple[rl.RooflineTerms, op_cost.OpCost, float]:
    """One LM step of ``kind`` (train, prefill, decode) at ``batch`` ×
    ``seq_len`` on ``mesh`` (every position on meta), counted: (its h100
    roofline terms, the ``OpCost``, its argument bytes per device)."""
    chips = int(np.prod(list(mesh.shape.values())))
    rules = _rules_for(cfg, mesh)
    params = api.params_specs(cfg)  # f32 masters; serving keeps them (serve_bf16 off)
    pairs = _spec_leaves(params, tree_param_specs(params, rules))
    with use_rules(rules):
        if kind == "train":
            tcfg = TrainConfig(opt=OptConfig(name=optimizer), microbatches=microbatches)
            opt = init_opt(params, tcfg.opt)
            batch_tree = api.input_specs(cfg, "train", batch=batch, seq_len=seq_len)
            pairs += _spec_leaves(opt, tree_param_specs(opt, rules))
            args = (params, opt, batch_tree)
            fn = make_train_step(cfg, tcfg)
        elif kind == "prefill":
            batch_tree = api.input_specs(cfg, "prefill", batch=batch, seq_len=seq_len)
            args = (params, batch_tree)
            fn = torch.no_grad()(lambda p, b: api.serve_prefill(p, cfg, b))
        elif kind == "decode":
            spec0 = api.input_specs(cfg, "decode", batch=batch, seq_len=seq_len)
            batch_tree = {"token": spec0["token"]}
            pairs += _spec_leaves(spec0["cache"], _cache_specs(mesh, spec0["cache"], batch))
            args = (params, spec0["token"], spec0["cache"])
            fn = torch.no_grad()(lambda p, t, c: api.serve_decode(p, cfg, t, c))
        else:
            raise ValueError(kind)
        _, cost = op_cost.count(fn, *args, chips=chips, registered=_registered(mesh, pairs))
    argument_bytes = _argument_bytes(mesh, pairs + _spec_leaves(batch_tree, _batch_specs(mesh, batch_tree, batch)))
    coll = rl.collective_bytes(
        kind, mesh.shape, cfg=cfg, params=params, rules=rules, batch=batch, seq_len=seq_len,
        microbatches=microbatches, batch_axes=_effective_batch_axes(mesh, batch))
    terms = rl.RooflineTerms(
        flops_per_dev=cost.flops, bytes_per_dev=cost.bytes,
        coll_bytes_per_dev=float(sum(coll.values())), coll_breakdown=coll,
        model_flops=rl.model_flops(cfg, kind, batch, seq_len),
        chips=chips, hardware=rl.hardware("h100"), flops_by_dtype=cost.flops_by_dtype)
    return terms, cost, argument_bytes


def _result(arch, shape_name, multi_pod, terms: rl.RooflineTerms, cost: op_cost.OpCost,
            argument_bytes: float, t0: float, chips: int) -> Dict[str, Any]:
    mem = {"argument_size_in_bytes": int(argument_bytes), "temp_size_in_bytes": int(cost.peak_bytes)}
    live = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "chips": chips,
        "ok": True,
        "count_seconds": round(time.time() - t0, 1),
        "memory": mem,
        "bytes_per_device_live": live,
        "fits_80gb": bool(live <= DEVICE_BYTES),
        "kernels": cost.kernels,
        "aten_ops": cost.ops,
        "roofline": terms.as_dict(),
    }


def all_cells():
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in shapes_for(cfg.family):
            yield arch, shape_name
    for shape_name in HQI_SEARCH_SHAPES:
        yield "hqi-search", shape_name


def load_results(path: str) -> Dict[str, Any]:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def save_results(res: Dict[str, Any], path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(res, f, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="count every (arch × shape × mesh) cell on meta tensors")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--cell", action="append", default=None, metavar="ARCH:SHAPE",
                    help="count only these cells (repeatable; with --mesh)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS_PATH, help="results file (default: dryrun_results_torch.json)")
    args = ap.parse_args(argv)

    path = os.path.abspath(args.out)
    results = load_results(path)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    todo = [
        (a, s, mp)
        for a, s in all_cells()
        for mp in meshes
        if (args.arch is None or a == args.arch) and (args.shape is None or s == args.shape)
        and (args.cell is None or f"{a}:{s}" in args.cell)
    ]
    print(f"dry-run: {len(todo)} cells")
    for arch, shape_name, mp in todo:
        key = f"{arch}|{shape_name}|{'multi' if mp else 'single'}"
        if key in results and results[key].get("ok") and not args.force:
            print(f"SKIP {key} (cached)")
            continue
        print(f"RUN  {key} ...", flush=True)
        try:
            res = count_cell(arch, shape_name, mp)
            r = res["roofline"]
            print(
                f"  OK  {res['count_seconds']}s  flops/dev={r['flops_per_dev']:.3e} "
                f"bytes/dev={r['bytes_per_dev']:.3e} coll/dev={r['coll_bytes_per_dev']:.3e} "
                f"bottleneck={r['bottleneck']} useful={r['useful_flop_ratio']:.2f}",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001
            res = {
                "arch": arch, "shape": shape_name,
                "mesh": "multi" if mp else "single",
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
            print(f"  FAIL {type(e).__name__}: {e}", flush=True)
        results[key] = res
        save_results(results, path)
    n_ok = sum(1 for v in results.values() if v.get("ok"))
    print(f"done: {n_ok}/{len(results)} cells ok")
    return results


if __name__ == "__main__":
    main()
