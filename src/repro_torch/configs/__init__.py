"""Architecture registry (counterpart of ``repro.configs``).

``get(name)`` returns the full published config; ``get(name, reduced=True)``
the same-family smoke-test config (small widths, few layers, tiny vocab)
used by the CPU tests. Every architecture of the JAX package is here.
"""

from __future__ import annotations

import importlib

ARCHS = (
    "deepseek_v2_236b",
    "kimi_k2_1t_a32b",
    "qwen3_8b",
    "qwen15_110b",
    "smollm_135m",
    "gemma3_4b",
    "jamba_15_large_398b",
    "phi3_vision_42b",
    "seamless_m4t_medium",
    "xlstm_13b",
)

ALIASES = {
    "deepseek-v2-236b": "deepseek_v2_236b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "qwen3-8b": "qwen3_8b",
    "qwen1.5-110b": "qwen15_110b",
    "smollm-135m": "smollm_135m",
    "gemma3-4b": "gemma3_4b",
    "jamba-1.5-large-398b": "jamba_15_large_398b",
    "phi-3-vision-4.2b": "phi3_vision_42b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "xlstm-1.3b": "xlstm_13b",
}


def get(name: str, reduced: bool = False):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced_config() if reduced else mod.config()
