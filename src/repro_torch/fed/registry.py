"""Deprecated shim (port of `repro.fed.registry`): the codec registry lives
in `repro_torch.codecs`.

    repro_torch.fed.registry.make(...)  ->  repro_torch.codecs.make(...)

Importing this module warns of nothing; calling `make()` through it emits a
DeprecationWarning. Everything else re-exports `repro_torch.codecs`.
"""
from __future__ import annotations

import warnings

from repro_torch.codecs import registry as _registry
from repro_torch.codecs.base import TreeCodec, TreeMeta  # noqa: F401
from repro_torch.codecs.registry import (_REGISTRY, _UNSET,  # noqa: F401
                                         available, codec_spec,
                                         gradcomp_config_for_budget, register)


def make(name, budget=_UNSET, **kwargs) -> TreeCodec:
    """Deprecated alias of `repro_torch.codecs.make`."""
    warnings.warn(
        "repro_torch.fed.registry has moved to repro_torch.codecs; call "
        "repro_torch.codecs.make(...)", DeprecationWarning, stacklevel=2)
    if budget is _UNSET:
        return _registry.make(name, **kwargs)
    return _registry.make(name, budget, **kwargs)
