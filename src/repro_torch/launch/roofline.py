"""Roofline terms: the hardware a dispatch's achieved rates are divided by.

``HardwareTerms`` holds a device's peak terms; ``current_hardware()`` names
the one this process runs on (``REPRO_HW`` picks a profile explicitly, as in
the reference). The dispatch profiler (``obs.profile``) divides each
dispatch's bytes and FLOPs (the reference's counts, from the plan's padded
shapes) by these terms, so a roofline share reads the same work whatever
kernel implements it. ``RooflineTerms`` and the analytic model FLOPs
(``active_params``, ``total_params``, ``model_flops``) are the reference's,
for the LM configs.

The per-device compute/memory/collective terms of a compiled step
(``collective_bytes``, which parses XLA HLO text) wait with the LM
scaffolding's dry run (ROADMAP.md §1, the rest of the LM scaffolding).
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
    """Peak terms the dispatch profiler normalizes achieved throughput by."""

    name: str
    peak_flops: float  # FLOP/s
    hbm_bw: float  # bytes/s
    link_bw: float  # bytes/s per link

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


# The cpu profile is deliberately conservative (the reference's figure): the
# roofline fractions the profiler reports on a CPU are only meaningful
# relative to a fixed denominator, so any stable figure works for
# regression tracking. h100: NVIDIA's published figures for the H100 SXM5
# 80GB at its 700 W limit: 67 TFLOP/s fp32 on CUDA cores (the scan kernels
# score in fp32 there, csrc/fused_knn.cu), 3.35 TB/s of HBM3, and 50 GB/s a
# link of NVLink 4 (900 GB/s over 18 links, both directions). A card set
# below 700 W runs slower under load: the shares read against these peaks.
_HW_PROFILES: Dict[str, HardwareTerms] = {
    "tpu-v5e": HardwareTerms("tpu-v5e", PEAK_FLOPS, HBM_BW, LINK_BW),
    "cpu": HardwareTerms("cpu", 5e11, 5e10, 1e10),
    "h100": HardwareTerms("h100", 67e12, 3.35e12, 50e9),
}


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


@dataclasses.dataclass
class RooflineTerms:
    """A compiled step's per-device terms against ``hardware`` (the
    reference's TPU v5e terms unless given)."""

    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: Dict[str, int]
    model_flops: float  # analytic 6·N_active·D (train) / 2·N_active·D (serve)
    chips: int
    hardware: HardwareTerms = _HW_PROFILES["tpu-v5e"]

    @property
    def compute_s(self) -> float:
        return self.flops_per_dev / self.hardware.peak_flops

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
        """Model-FLOPs utilization at the roofline-model step time."""
        t = self.step_time_s
        return (self.model_flops / (self.chips * self.hardware.peak_flops)) / t if t else 0.0

    def as_dict(self) -> Dict:
        return {
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
