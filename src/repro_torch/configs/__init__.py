"""Architecture registry of the port: the reference's configurations for
the archs that are ported and the paper's LeNet-5 (the reference's
``configs/__init__.py`` imports JAX, so this is its own small copy).

Each ``<arch>.py`` exposes ``config()`` (the published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests); ``lenet5``
also ``sc_config(bits)``.
"""
from __future__ import annotations

import importlib

ARCHS = ("stablelm_3b", "starcoder2_15b", "deepseek_67b", "llama3_405b",
         "deepseek_moe_16b", "moonshot_v1_16b_a3b", "hymba_1_5b",
         "whisper_medium", "llama32_vision_90b", "rwkv6_7b", "lenet5")
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
# the published names
ALIASES["hymba-1.5b"] = "hymba_1_5b"
ALIASES["llama-3.2-vision-90b"] = "llama32_vision_90b"


def get(arch: str):
    mod = ALIASES.get(arch, arch)
    if mod not in ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not in the port's registry (ported: "
            f"{ARCHS}); see ROADMAP.md")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def config(arch: str):
    return get(arch).config()


def smoke_config(arch: str):
    return get(arch).smoke_config()
