"""Architecture registry (port of `repro.configs`): the ten configs of the
reference (`ARCH_NAMES`), and the port's own beyond them (`PORT_NAMES`),
each citing its source paper or model card. `get(name)` returns the full
ModelConfig, `get_reduced(name)` the small smoke variant the CPU tests
use (≤2 layers; one period of the layer pattern where it has one)."""
from __future__ import annotations

from repro_torch.configs import (arctic_480b, hubert_xlarge, hymba_1_5b,
                                 llama3_2_3b, mellum2_12b_a2_5b,
                                 mistral_large_123b, mixtral_8x22b,
                                 phi3_mini_3_8b, pixtral_12b, xlstm_350m,
                                 yi_6b)
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

ARCH_NAMES = tuple(_MODULES)                # the reference's ten
_PORT_MODULES = {
    "mellum2-12b-a2.5b": mellum2_12b_a2_5b,
}
PORT_NAMES = tuple(_PORT_MODULES)           # the port's own
ALL_NAMES = ARCH_NAMES + PORT_NAMES

__all__ = ["ALL_NAMES", "ARCH_NAMES", "PORT_NAMES", "SHAPES", "InputShape",
           "applicable", "get", "get_reduced", "input_specs"]


def _module(name: str):
    found = _MODULES.get(name) or _PORT_MODULES.get(name)
    if found is None:
        raise KeyError(f"unknown arch {name!r}; known: {ALL_NAMES}")
    return found


def get(name: str):
    return _module(name).config()


def get_reduced(name: str):
    return _module(name).reduced()
