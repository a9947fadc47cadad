"""Architecture registry: the 10 assigned configs, the port's own copies.

``get_config(name)`` returns the exact published ModelConfig;
``get_smoke_config(name)`` the reduced same-family variant for CPU tests.
"""
from __future__ import annotations

import importlib
from typing import List

ARCH_IDS = [
    "hymba_1p5b", "qwen2_7b", "xlstm_350m", "command_r_plus_104b",
    "qwen3_moe_235b_a22b", "qwen3_32b", "whisper_small", "gemma2_9b",
    "granite_moe_1b_a400m", "llama_3_2_vision_90b",
]

# CLI aliases: --arch hymba-1.5b etc.
ALIASES = {
    "hymba-1.5b": "hymba_1p5b",
    "qwen2-7b": "qwen2_7b",
    "xlstm-350m": "xlstm_350m",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-32b": "qwen3_32b",
    "whisper-small": "whisper_small",
    "gemma2-9b": "gemma2_9b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    for alias, mod in ALIASES.items():
        if name == alias.replace("-", "_").replace(".", "_"):
            return mod
    if name in ARCH_IDS:
        return name
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")


def get_config(name: str):
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.CONFIG


def get_smoke_config(name: str):
    return get_config(name).scaled_down()


def all_arch_names() -> List[str]:
    return list(ALIASES.keys())
