"""Config registry of the archs whose family the port runs (dense).

get_config(arch_id) -> full ModelConfig; get_reduced(arch_id) -> the small
config of the same wiring the CPU tests use. Copies of the reference's
``repro.configs`` modules for these archs; the other six (internvl2-2b,
mamba2-130m, whisper-large-v3, kimi-k2-1t-a32b, deepseek-moe-16b,
zamba2-2.7b) wait for their families (ROADMAP.md §1, the rest of the LM
scaffolding).
"""
from importlib import import_module

ARCHS = {
    "minicpm-2b": "minicpm_2b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-32b": "qwen3_32b",
    "qwen1.5-110b": "qwen1_5_110b",
}


def _module(arch_id: str):
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r} for repro_torch; ported: {sorted(ARCHS)}")
    return import_module(f".{ARCHS[arch_id]}", __package__)


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str):
    return _module(arch_id).reduced()
