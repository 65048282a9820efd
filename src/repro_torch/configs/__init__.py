"""Configurations (port of ``src/repro/configs``): the ProxyFL protocol
knobs (``DPConfig``, ``ProxyFLConfig``), the model dataclasses and the
architecture registry, with the reference's registered names.

``get_config(name)`` builds a registered architecture's ``ModelConfig``,
``proxy_of`` the common proxy its federation agrees on, and
``smoke_variant`` a reduced model of the same family. Importing the arch
modules populates the registry; ``paper_small`` holds the paper's own
experimental settings.
"""
from .base import (
    DPConfig,
    InputShape,
    INPUT_SHAPES,
    LayerSpec,
    MambaConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ProxyFLConfig,
)
from .registry import get_config, list_archs, proxy_of, register, smoke_variant

# importing the arch modules populates the registry
from . import (  # noqa: F401
    arctic_480b,
    deepseek_v2_236b,
    falcon_mamba_7b,
    gemma3_4b,
    jamba_1_5_large_398b,
    musicgen_medium,
    phi_3_vision_4_2b,
    qwen1_5_110b,
    qwen1_5_4b,
    qwen2_7b,
)
from . import paper_small  # noqa: F401

ASSIGNED_ARCHS = [
    "deepseek-v2-236b",
    "qwen2-7b",
    "phi-3-vision-4.2b",
    "arctic-480b",
    "musicgen-medium",
    "falcon-mamba-7b",
    "gemma3-4b",
    "jamba-1.5-large-398b",
    "qwen1.5-110b",
    "qwen1.5-4b",
]

__all__ = [
    "DPConfig",
    "InputShape",
    "INPUT_SHAPES",
    "LayerSpec",
    "MambaConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "ProxyFLConfig",
    "get_config",
    "list_archs",
    "proxy_of",
    "register",
    "smoke_variant",
    "ASSIGNED_ARCHS",
]
