"""Architecture registry (port of `repro.configs`): so far yi-6b, the
trainer's default `--arch`. `get(name)` returns the full ModelConfig,
`get_reduced(name)` the ≤2-layer smoke variant the CPU tests use."""
from __future__ import annotations

from repro_torch.configs import yi_6b

_MODULES = {
    "yi-6b": yi_6b,
}

ARCH_NAMES = tuple(_MODULES)


def get(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _MODULES[name].config()


def get_reduced(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return _MODULES[name].reduced()
