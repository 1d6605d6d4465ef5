"""Architecture registry of the port.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` the reduced same-family variant the CPU tests
use.  The dense families (qwen2.5-3b, internlm2-1.8b, yi-9b, gemma-7b),
the MoE family (mixtral-8x7b, moonshot-v1-16b-a3b) and the state-space
families (mamba2-2.7b, jamba-1.5-large-398b) are ported; the other
architectures of the reference registry are listed in ROADMAP.md (queue
1, M8).
"""

from __future__ import annotations

import importlib

ARCH_IDS = ("gemma-7b", "yi-9b", "qwen2.5-3b", "internlm2-1.8b",
            "mixtral-8x7b", "moonshot-v1-16b-a3b", "mamba2-2.7b",
            "jamba-1.5-large-398b")

_MODULES = {
    "gemma-7b": "gemma_7b",
    "yi-9b": "yi_9b",
    "qwen2.5-3b": "qwen2_5_3b",
    "internlm2-1.8b": "internlm2_1_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "mamba2-2.7b": "mamba2_2_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"{arch_id!r} is not ported to repro_torch yet (ported: "
            f"{', '.join(ARCH_IDS)}); see ROADMAP.md, queue 1, M8")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()
