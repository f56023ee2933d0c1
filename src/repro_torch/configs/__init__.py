"""Architecture registry (port of `repro.configs`): the ten configs of the
reference, each citing its source paper or model card. `get(name)` returns
the full ModelConfig, `get_reduced(name)` the ≤2-layer smoke variant the
CPU tests use."""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, hubert_xlarge, hymba_1_5b,
                                 llama3_2_3b, mistral_large_123b,
                                 mixtral_8x22b, phi3_mini_3_8b, pixtral_12b,
                                 xlstm_350m, yi_6b)
from repro_torch.configs.shapes import (SHAPES, InputShape, applicable,
                                        input_specs)

_MODULES = {
    "hymba-1.5b": hymba_1_5b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "yi-6b": yi_6b,
    "arctic-480b": arctic_480b,
    "pixtral-12b": pixtral_12b,
    "hubert-xlarge": hubert_xlarge,
    "llama3.2-3b": llama3_2_3b,
    "mixtral-8x22b": mixtral_8x22b,
    "mistral-large-123b": mistral_large_123b,
    "xlstm-350m": xlstm_350m,
}

ARCH_NAMES = tuple(_MODULES)

__all__ = ["ARCH_NAMES", "SHAPES", "InputShape", "applicable", "get",
           "get_reduced", "input_specs"]


def get(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _MODULES[name].config()


def get_reduced(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _MODULES[name].reduced()
