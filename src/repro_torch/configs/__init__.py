"""Architecture registry of the PyTorch port: every architecture of the
reference registry, one module each.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` a reduced same-family config for CPU tests.
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCH_IDS = (
    "musicgen_medium",
    "gemma3_1b",
    "command_r_plus_104b",
    "minitron_8b",
    "phi3_mini_3p8b",
    "deepseek_moe_16b",
    "grok1_314b",
    "falcon_mamba_7b",
    "llava_next_34b",
    "recurrentgemma_2b",
)

# cli-friendly aliases (hyphens, paper spellings)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "grok-1-314b": "grok1_314b",
    "command-r-plus-104b": "command_r_plus_104b",
})


def resolve(arch: str) -> str:
    arch_n = arch.replace("-", "_").replace(".", "p")
    if arch_n in ARCH_IDS:
        return arch_n
    if arch in ALIASES:
        return ALIASES[arch]
    raise KeyError(f"unknown arch {arch!r}; known: {list(ARCH_IDS)}")


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __name__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{resolve(arch)}", __name__)
    return mod.SMOKE


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# -- input shapes (assigned) --------------------------------------------------

SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}


def cell_is_runnable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason). long_500k only for sub-quadratic archs."""
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k dense KV cache excluded by shape contract"
    return True, ""
