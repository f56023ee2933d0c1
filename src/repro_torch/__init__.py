"""PyTorch/CUDA port of the `repro` package (compressed gradient consensus).

Mirrors `repro`'s module paths (`repro/<pkg>/<mod>.py` →
`repro_torch/<pkg>/<mod>.py`). The codec's hot path runs on hand-written
Hopper kernels (`repro_torch/csrc/`, dispatched by `repro_torch.kernels.ops`);
on a CPU tensor every wrapper uses its kernel's plain PyTorch version.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
GPU and no explicit CPU request they raise instead of quietly running on the
CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, defaulting to `cuda`; a bare `cuda`
    gets the current card's index, so it compares equal to a tensor's
    device.

    Raises if CUDA is asked for (explicitly or by default) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
