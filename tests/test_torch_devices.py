"""The port's entry points run on `cuda` unless asked for the CPU: with no
GPU and no device given, each constructor raises instead of quietly
running on the CPU; given `device="cpu"` it runs there. (The card is
hidden with monkeypatch, so this holds on a machine with one too.)"""
import pytest
import torch

from repro_torch import configs
from repro_torch import fed
from repro_torch.data import pipeline
from repro_torch.dist import gradcomp, step
from repro_torch.models import decode, model
from repro_torch.optimizer import optim

_CFG = configs.get_reduced("yi-6b")
_OPT = optim.adamw(1e-3)
_GC = gradcomp.GradCompConfig(bits=4, chunk=64)

CALLS = {
    "init_train_state": lambda **d: step.init_train_state(
        _CFG, _OPT, _GC, **d),
    "init_params": lambda **d: model.init_params(0, _CFG, **d),
    "init_decode_state": lambda **d: decode.init_decode_state(
        _CFG, 1, 8, **d),
    "batch_for_shape": lambda **d: pipeline.batch_for_shape(
        _CFG, 2, 4, **d),
    "synthetic_regression": lambda **d: pipeline.synthetic_regression(
        0, 10, 4, **d),
    "synthetic_two_class": lambda **d: pipeline.synthetic_two_class(
        0, 5, 4, **d),
    "Federation": lambda **d: fed.Federation(
        lambda p, b: (p["x"] ** 2).sum(), {"x": torch.zeros(4)},
        [{"a": torch.zeros(2, 4)}], fed.make("identity"), **d),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_entry_points_default_to_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CALLS[name]()
    CALLS[name](device="cpu")
