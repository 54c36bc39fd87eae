"""Roofline terms: the hardware a dispatch's achieved rates are divided by.

``HardwareTerms`` holds a device's peak terms; ``current_hardware()`` names
the one this process runs on (``REPRO_HW`` picks a profile explicitly, as in
the reference). The dispatch profiler (``obs.profile``) divides each
dispatch's bytes and FLOPs (the reference's counts, from the plan's padded
shapes) by these terms, so a roofline share reads the same work whatever
kernel implements it. ``RooflineTerms`` and the analytic model FLOPs
(``active_params``, ``total_params``, ``model_flops``) are the reference's,
for the LM configs.

The dry run (``launch/dryrun.py``) takes each step's FLOPs and bytes from
``launch.op_cost`` and its collective bytes from ``collective_bytes``,
which derives them from the sharding rules' axis tuples and the step's
shapes (the reference parses them from XLA's HLO text, which the port
does not have). ``RooflineTerms`` divides each type's FLOPs by that type's
peak (``HardwareTerms.peak``); the dry run passes ``hardware=h100``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

# The reference's TPU v5e terms (197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s a
# link of ICI), kept as its profile; no number of the port is taken against them.
PEAK_FLOPS = 197e12  # bf16 per chip
HBM_BW = 819e9  # bytes/s per chip
LINK_BW = 50e9  # bytes/s per ICI link


@dataclasses.dataclass(frozen=True)
class HardwareTerms:
    """Peak terms the dispatch profiler normalizes achieved throughput by.

    ``peak_flops`` is the rate the profiler divides by (the h100's fp32
    CUDA-core figure, at which the scans score); ``peak_flops_bf16`` the
    rate of bf16 products, which the dry run's compute term divides the
    bf16 FLOPs by (``peak``). ``as_dict`` keeps the reference's four keys,
    which the profiler's report carries."""

    name: str
    peak_flops: float  # FLOP/s
    hbm_bw: float  # bytes/s
    link_bw: float  # bytes/s per link
    peak_flops_bf16: float  # FLOP/s of bf16 products

    def peak(self, dtype: str) -> float:
        """FLOP/s for products of ``dtype`` ("bf16" or "f32", as
        ``op_cost.dtype_key`` names them)."""
        return self.peak_flops_bf16 if dtype == "bf16" else self.peak_flops

    def as_dict(self) -> Dict[str, object]:
        return {k: getattr(self, k) for k in ("name", "peak_flops", "hbm_bw", "link_bw")}


# The cpu profile is deliberately conservative (the reference's figure): the
# roofline fractions the profiler reports on a CPU are only meaningful
# relative to a fixed denominator, so any stable figure works for
# regression tracking. h100: NVIDIA's published figures for the H100 SXM5
# 80GB at its 700 W limit: 67 TFLOP/s fp32 on CUDA cores (the scan kernels
# score in fp32 there, csrc/fused_knn.cu), 989 TFLOP/s of dense bf16 on the
# tensor cores, 3.35 TB/s of HBM3, and 50 GB/s a link of NVLink 4 (900 GB/s
# over 18 links, both directions). A card set below 700 W runs slower under
# load: the shares read against these peaks. The reference's two profiles
# have one figure, given for both types.
_HW_PROFILES: Dict[str, HardwareTerms] = {
    "tpu-v5e": HardwareTerms("tpu-v5e", PEAK_FLOPS, HBM_BW, LINK_BW, PEAK_FLOPS),
    "cpu": HardwareTerms("cpu", 5e11, 5e10, 1e10, 5e11),
    "h100": HardwareTerms("h100", 67e12, 3.35e12, 50e9, 989e12),
}


def hardware(name: str) -> HardwareTerms:
    """The named profile ("tpu-v5e", "cpu" or "h100")."""
    return _HW_PROFILES[name]


def current_hardware() -> HardwareTerms:
    """Hardware terms for the machine running now.

    ``REPRO_HW`` names a profile explicitly; otherwise a CUDA device whose
    name says H100 maps to h100 and anything else (the CPU) to the cpu
    profile, as the reference maps its non-TPU backends.
    """
    name = os.environ.get("REPRO_HW")
    if name:
        try:
            return _HW_PROFILES[name]
        except KeyError:
            raise ValueError(
                f"unknown REPRO_HW={name!r}; one of {sorted(_HW_PROFILES)}"
            ) from None
    import torch

    if torch.cuda.is_available() and "H100" in torch.cuda.get_device_name():
        return _HW_PROFILES["h100"]
    return _HW_PROFILES["cpu"]


# ---------------------------------------------------------------------------
# collective bytes per device, from the axis tuples and the step's shapes
# ---------------------------------------------------------------------------

# the reference's kind names (``collective-permute`` appears in no step the port models)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_BATCH_AXES = ("pod", "data")


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _size(mesh_shape: Dict[str, int], names) -> int:
    n = 1
    for a in names:
        n *= int(mesh_shape[a])
    return n


def collective_bytes(step: str, mesh_shape: Dict[str, int], **shapes) -> Dict[str, int]:
    """Per-device bytes of each collective kind one step moves — the
    counterpart of the reference's HLO parse, derived from the sharding
    rules' axis tuples and the step's shapes (the result bytes of each
    collective, as the reference sums them).

    ``step="hqi-search"`` (``m``, ``k``): the roofline search step's one
    cross-rank step, the gather of every model rank's top-k (an f32 score
    and an int32 id, 8 bytes) for each of the device's queries:
    ``|model| · (m / batch shards) · k · 8`` all-gathered.

    ``step`` "train", "prefill" or "decode" (``cfg``, ``params``: the
    leaves' meta tensors, ``rules``: the ``ShardingRules`` that give their
    axis tuples, ``batch``, ``seq_len``, ``microbatches``, ``batch_axes``:
    the mesh axes the batch splits over) — the LM model, each term per
    pass over the layers (a
    training microbatch makes three: the forward, the checkpoint's
    recomputed forward, the backward; serving one forward):

      * FSDP (a leaf whose axis tuple holds a batch axis): all-gathered per
        use, at its size with only its other axes left; in training its
        gradient is reduce-scattered once a microbatch;
      * a leaf replicated over a batch axis the step splits (plain data
        parallelism): its gradient all-reduced once a microbatch;
      * tensor parallelism (the "model" axis on a matmul's input dim,
        row-parallel, or on its output dim, column-parallel): the
        row-parallel output [tokens, out] all-reduced in each forward pass,
        the column-parallel input's gradient [tokens, in] in each backward,
        once for the leaves of one block that read one input (wq, wk and
        wv; w_up and w_gate); a vocab-sharded embedding counts as
        row-parallel;
      * moe experts on "data" (the expert-parallel training schedule,
        ``models.moe.moe_layer_ep``): two all-to-alls of the device's send
        buffer [E, cap, D] a layer and pass; serving runs the dense
        formulation and moves none.

    Tokens are the device's rows times the text positions (vision patches
    included) or, for an encoder's leaves and the cross-attention's K/V,
    the encoder frames; a decode step has one position and reads the
    encoder's K/V from its cache. Activations move in ``cfg.dtype``;
    parameters and gradients at their leaves' type. Replicated work is not
    modelled (ROADMAP.md §3)."""
    out = {kind: 0.0 for kind in COLLECTIVES}
    if step == "hqi-search":
        shards = _size(mesh_shape, [a for a in _BATCH_AXES if a in mesh_shape])
        out["all-gather"] = mesh_shape["model"] * (shapes["m"] / shards) * shapes["k"] * 8
        return {kind: int(v) for kind, v in out.items() if v}
    return _lm_collectives(step, mesh_shape, out, **shapes)


def _lm_collectives(kind: str, mesh_shape, out, *, cfg, params, rules, batch: int, seq_len: int,
                    microbatches: int = 1, batch_axes=()) -> Dict[str, int]:
    from ..distributed.sharding import param_spec_for
    from ..models.tree import leaves_with_paths, path_key

    train = kind == "train"
    mb = max(int(microbatches), 1) if train else 1
    fwd_passes, bwd_passes = (2 * mb, mb) if train else (1, 0)
    rows = batch / _size(mesh_shape, batch_axes) / mb  # the device's rows a pass
    text = 1 if kind == "decode" else seq_len + (cfg.vision_patches if cfg.family == "vlm" else 0)
    act = cfg.dtype.itemsize
    model = int(mesh_shape.get("model", 1))
    mesh_batch = [a for a in _BATCH_AXES if a in mesh_shape]
    groups = cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid" else 1

    ep = _ep_shape(cfg, mesh_shape, batch // mb, seq_len) if train and cfg.family == "moe" else None
    inputs = set()  # (block, reads the encoder's frames): column-parallel inputs already summed
    for path, leaf in leaves_with_paths(params):
        key = path_key(path)
        spec = param_spec_for(key, tuple(leaf.shape), rules)
        nbytes = leaf.numel() * leaf.element_size()
        expert = "experts" in key
        frames = key.startswith("enc_") or "xattn/wk" in key or "xattn/wv" in key
        if kind == "decode" and frames:
            continue  # the encoder's K/V come from the cache
        uses = groups if key.startswith("shared_attn") else 1
        every = [n for e in spec for n in _names(e)]
        names = [n for i, e in enumerate(spec) for n in _names(e) if not (expert and i == 0)]
        fsdp = [n for n in names if n in _BATCH_AXES]
        if fsdp:
            gathered = nbytes / _size(mesh_shape, [n for n in names if n not in _BATCH_AXES])
            out["all-gather"] += gathered * uses * (fwd_passes + bwd_passes)
        if train:
            shard = nbytes / _size(mesh_shape, every)
            if fsdp:
                out["reduce-scatter"] += shard * mb
            elif _size(mesh_shape, [a for a in mesh_batch if a not in every]) > 1:
                out["all-reduce"] += shard * mb
        if model > 1 and leaf.dim() >= 2:
            tokens = rows * (cfg.encoder_frames if frames else text)
            if expert:
                tokens = ep["rows"] if ep else rows * text * cfg.moe.top_k
            if "model" in _names(spec[-2]):  # row-parallel: its output summed over the ranks
                out["all-reduce"] += tokens * leaf.shape[-1] * act * uses * fwd_passes
            elif "model" in _names(spec[-1]) and bwd_passes:  # column-parallel: its input's gradient
                block = (key.rsplit("/", 1)[0], frames)
                if block not in inputs:
                    inputs.add(block)
                    out["all-reduce"] += tokens * leaf.shape[-2] * act * uses * bwd_passes
    if ep:
        out["all-to-all"] += 2 * ep["send_bytes"] * act * ep["layers"] * (fwd_passes + bwd_passes)
    return {k: int(v) for k, v in out.items() if v}


def _ep_shape(cfg, mesh_shape, mb_rows: int, seq_len: int):
    """The expert-parallel schedule's buffers a device holds (None where
    ``moe_layer_ep`` would not run: no "data" axis dividing the experts, or
    a microbatch the batch axes cannot split): ``rows`` of its expert
    products, E·cap_e, and the elements of its send buffer, E·cap_e·D."""
    m = cfg.moe
    dp = int(mesh_shape.get("data", 1))
    bp = _size(mesh_shape, [a for a in _BATCH_AXES if a in mesh_shape])
    if "data" not in mesh_shape or m.n_experts % dp or mb_rows % bp:
        return None
    t_loc = (mb_rows // bp) * seq_len
    cap_e = int(max(1, (t_loc * m.top_k * m.capacity_factor) // m.n_experts))
    return {"rows": m.n_experts * cap_e, "send_bytes": m.n_experts * cap_e * cfg.d_model,
            "layers": cfg.n_layers - cfg.moe_first_dense}


@dataclasses.dataclass
class RooflineTerms:
    """A step's per-device terms against ``hardware`` (the reference's TPU
    v5e terms unless given). ``flops_by_dtype`` splits ``flops_per_dev`` by
    the type of the products ("bf16", "f32"), each share run at its own
    peak (``HardwareTerms.peak``)."""

    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: Dict[str, int]
    model_flops: float  # analytic 6·N_active·D (train) / 2·N_active·D (serve)
    chips: int
    flops_by_dtype: Dict[str, float]
    hardware: HardwareTerms = _HW_PROFILES["tpu-v5e"]

    @property
    def compute_s(self) -> float:
        return sum(f / self.hardware.peak(dt) for dt, f in self.flops_by_dtype.items())

    @property
    def memory_s(self) -> float:
        return self.bytes_per_dev / self.hardware.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_dev / self.hardware.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s, "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        hlo_global = self.flops_per_dev * self.chips
        return self.model_flops / hlo_global if hlo_global else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-model step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-model step time, against
        the peak of the step's own mix of types (its FLOPs over its compute
        term)."""
        t = self.step_time_s
        peak = self.flops_per_dev / self.compute_s if self.compute_s > 0 else self.hardware.peak_flops
        return (self.model_flops / (self.chips * peak)) / t if t else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops_by_dtype": dict(self.flops_by_dtype),
            "hardware": self.hardware.name,
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flop_ratio": self.useful_flop_ratio,
            "mfu": self.mfu,
        }


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS per arch/shape
# ---------------------------------------------------------------------------


def active_params(cfg) -> int:
    """Per-token active parameter count (MoE: shared + top-k routed only)."""
    d = cfg.d_model
    dh = cfg.dh
    emb = cfg.vocab * d

    def attn_params():
        return d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh + cfg.n_heads * dh * d

    def dense_mlp(ff):
        return 3 * d * ff  # swiglu

    if cfg.family in ("dense", "vlm"):
        per_layer = attn_params() + dense_mlp(cfg.d_ff)
        return cfg.n_layers * per_layer + emb
    if cfg.family == "moe":
        m = cfg.moe
        routed = m.top_k * 3 * d * m.d_ff_expert
        shared = 3 * d * (m.d_ff_shared or m.d_ff_expert * m.n_shared_experts) if m.n_shared_experts else 0
        router = d * m.n_experts
        moe_layer = attn_params() + routed + shared + router
        dense_layer = attn_params() + dense_mlp(cfg.d_ff)
        return (cfg.n_layers - cfg.moe_first_dense) * moe_layer + cfg.moe_first_dense * dense_layer + emb
    if cfg.family == "ssm":
        s = cfg.ssm
        per = s.d_model * (2 * s.d_inner + 2 * s.d_state + s.n_heads) + s.d_inner * s.d_model
        return cfg.n_layers * per + emb
    if cfg.family == "hybrid":
        s = cfg.ssm
        per = s.d_model * (2 * s.d_inner + 2 * s.d_state + s.n_heads) + s.d_inner * s.d_model
        shared = attn_params() + dense_mlp(cfg.d_ff)
        groups = cfg.n_layers // cfg.hybrid_attn_every
        return cfg.n_layers * per + groups * shared + emb
    if cfg.family == "encdec":
        dec = cfg.n_layers * (2 * attn_params() + 2 * d * cfg.d_ff)  # self+cross, ungated mlp
        enc = cfg.encoder_layers * (attn_params() + 2 * d * cfg.d_ff)
        return dec + enc + emb
    raise ValueError(cfg.family)


def total_params(cfg) -> int:
    if cfg.family != "moe":
        return active_params(cfg)
    d = cfg.d_model
    dh = cfg.dh
    m = cfg.moe
    attn = d * cfg.n_heads * dh + 2 * d * cfg.n_kv_heads * dh + cfg.n_heads * dh * d
    routed_all = m.n_experts * 3 * d * m.d_ff_expert
    shared = 3 * d * (m.d_ff_shared or m.d_ff_expert * m.n_shared_experts) if m.n_shared_experts else 0
    moe_layer = attn + routed_all + shared + d * m.n_experts
    dense_layer = attn + 3 * d * cfg.d_ff
    return (
        (cfg.n_layers - cfg.moe_first_dense) * moe_layer
        + cfg.moe_first_dense * dense_layer
        + cfg.vocab * d
    )


def model_flops(cfg, kind: str, batch: int, seq_len: int) -> float:
    n_act = active_params(cfg)
    if kind == "train":
        return 6.0 * n_act * batch * seq_len
    if kind == "prefill":
        return 2.0 * n_act * batch * seq_len
    if kind == "decode":
        return 2.0 * n_act * batch  # one token per sequence
    raise ValueError(kind)
