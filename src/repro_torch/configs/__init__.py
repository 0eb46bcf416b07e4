"""Architecture registry (copy of ``repro.configs``): one module per
assigned arch. ``get_config(name)`` returns the full published
config; ``get_smoke_config(name)`` the reduced same-family config."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, scaled_down

ARCHS = [
    "musicgen_large",
    "dbrx_132b",
    "moonshot_v1_16b_a3b",
    "qwen1_5_32b",
    "llama3_405b",
    "gemma3_1b",
    "yi_34b",
    "jamba_1_5_large_398b",
    "falcon_mamba_7b",
    "llava_next_mistral_7b",
]

ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def canonical(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key in ARCHS:
        return key
    if name in ALIASES:
        return ALIASES[name]
    raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    smoke = getattr(mod, "SMOKE", None)
    return smoke if smoke is not None else scaled_down(mod.CONFIG)
