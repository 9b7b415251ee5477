"""Architecture registry: --arch <id> → (FULL, SMOKE) ModelConfigs."""

from repro_torch.configs import (codeqwen15_7b, glm4_9b, granite_34b,
                                 internvl2_26b, llama4_scout, mamba2_130m,
                                 mixtral_8x7b, musicgen_medium, paper_mnist,
                                 phi4_mini_38b, zamba2_12b)
from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeSpec,
                                      shape_cells)
from repro_torch.configs.paper_mnist import PaperConfig

_MODULES = {
    "granite-34b": granite_34b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "glm4-9b": glm4_9b,
    "phi4-mini-3.8b": phi4_mini_38b,
    "mixtral-8x7b": mixtral_8x7b,
    "llama4-scout-17b-a16e": llama4_scout,
    "zamba2-1.2b": zamba2_12b,
    "internvl2-26b": internvl2_26b,
    "mamba2-130m": mamba2_130m,
    "musicgen-medium": musicgen_medium,
}

ARCHS = list(_MODULES)
PAPER = paper_mnist.PAPER


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.FULL


__all__ = ["ARCHS", "PAPER", "SHAPES", "ModelConfig", "PaperConfig",
           "ShapeSpec", "get_config", "shape_cells"]
