"""Architecture registry of the PyTorch port.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
The port runs the dense global-attention family, gemma3 (local and global
attention), recurrentgemma (RG-LRU and local attention) and falcon-mamba
(Mamba-1) so far; the other architectures of the reference registry come
with their slices, and asking for one raises.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = ("phi3_mini_3p8b", "gemma3_1b", "recurrentgemma_2b",
            "falcon_mamba_7b")

# architectures the reference registry knows that this port does not run yet
PENDING_ARCH_IDS = (
    "musicgen_medium", "command_r_plus_104b", "minitron_8b",
    "deepseek_moe_16b", "grok1_314b", "llava_next_34b",
)

ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES["phi3-mini-3.8b"] = "phi3_mini_3p8b"


def resolve(arch: str) -> str:
    arch_n = arch.replace("-", "_").replace(".", "p")
    if arch_n in ARCH_IDS:
        return arch_n
    if arch in ALIASES:
        return ALIASES[arch]
    if arch_n in PENDING_ARCH_IDS:
        raise NotImplementedError(
            f"{arch!r} is not ported to the PyTorch package yet")
    raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __name__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __name__)
    return mod.SMOKE
