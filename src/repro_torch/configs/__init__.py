"""Config registry of the archs, every family the port runs (dense, moe,
ssm, hybrid, encdec, vlm).

get_config(arch_id) -> full ModelConfig; get_reduced(arch_id) -> the small
config of the same wiring the CPU tests use; optimizer_for / schedule_for
-> the optimizer and learning-rate schedule an arch trains with. Copies of
the reference's ``repro.configs`` modules, all ten of its ``ARCHS``.
``shapes`` holds the assigned input shapes.
"""
from importlib import import_module

ARCHS = {
    "internvl2-2b": "internvl2_2b",
    "minicpm-2b": "minicpm_2b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-110b": "qwen1_5_110b",
    "mamba2-130m": "mamba2_130m",
    "whisper-large-v3": "whisper_large_v3",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-2.7b": "zamba2_2p7b",
}


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} for repro_torch; known: {sorted(ARCHS)}")
    return import_module(f".{ARCHS[arch_id]}", __package__)


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str):
    return _module(arch_id).reduced()


def optimizer_for(arch_id: str) -> str:
    return getattr(_module(arch_id), "OPTIMIZER", "adamw")


def schedule_for(arch_id: str) -> str:
    return getattr(_module(arch_id), "SCHEDULE", "cosine")
