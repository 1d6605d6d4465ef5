"""Architecture registry of the port.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU tests
use.  All ten architectures of the reference registry are here, in its
order: the dense families (gemma-7b, yi-9b, qwen2.5-3b, internlm2-1.8b),
the audio family (musicgen-large), the MoE family (moonshot-v1-16b-a3b,
mixtral-8x7b), the vision family (llama-3.2-vision-90b) and the
state-space families (jamba-1.5-large-398b, mamba2-2.7b).
"""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "gemma-7b",
    "yi-9b",
    "qwen2.5-3b",
    "internlm2-1.8b",
    "musicgen-large",
    "moonshot-v1-16b-a3b",
    "mixtral-8x7b",
    "llama-3.2-vision-90b",
    "jamba-1.5-large-398b",
    "mamba2-2.7b",
)

_MODULES = {
    "gemma-7b": "gemma_7b",
    "yi-9b": "yi_9b",
    "qwen2.5-3b": "qwen2_5_3b",
    "internlm2-1.8b": "internlm2_1_8b",
    "musicgen-large": "musicgen_large",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "mamba2-2.7b": "mamba2_2_7b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r} (known: "
                       f"{', '.join(ARCH_IDS)})")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()
