"""The plain reference agrees with the port at a tiny size on the CPU:
the model's loss and gradients, the codec's frame signs and round trip,
and a whole checked step (`bench.train` against `bench.reference.train`)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny
from bench import harness, train, weights
from bench.reference import codec, model


@pytest.mark.parametrize("name", ["yi6b-train-ndsc", "mixtral-train-ndsc"])
def test_loss_and_gradients(name):
    from repro_torch.models import model as port

    c = tiny.cell(name)
    cfg = c["cfg"]
    params = weights.make_params(cfg, 5, "cpu")
    tokens = weights.token_rows(cfg, 5, 1, 4, 16, "cpu")[0]
    leaves = weights.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    want = model.loss(cfg, params, tokens)
    got = port.loss_fn(train.model_config(cfg), params, {"tokens": tokens})
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    g_want = torch.autograd.grad(want, leaves)
    g_got = torch.autograd.grad(got, leaves)
    for a, b in zip(g_got, g_want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-7)


def test_frame_signs_match_the_port():
    from repro_torch.dist import gradcomp

    for leaf in (0, 3, 12):
        for seed in (0, 7):
            gc = gradcomp.GradCompConfig(chunk=256, seed=seed)
            want = gradcomp._frame_signs(leaf, gc, "cpu").numpy()
            assert np.array_equal(codec.frame_signs(seed, leaf, 256), want)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_codec_roundtrip_matches_the_port(bits):
    from repro_torch.dist import gradcomp

    gc = gradcomp.GradCompConfig(bits=bits, chunk=256)
    u = torch.randn(37, 300, generator=torch.Generator().manual_seed(bits))
    payload, resid = gradcomp.encode_leaf_ef(u, 4, gc)
    got = gradcomp.decode_leaf(payload, 4, u.numel(), u.shape, u.dtype, gc)
    signs = torch.from_numpy(codec.frame_signs(0, 4, 256))
    want = codec.roundtrip(u, signs, bits, 256, block_rows=16)
    assert torch.equal(got, want)
    assert torch.allclose(resid, u - want, atol=1e-6)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_checked_steps_agree(name):
    import time

    out = train.run(harness.Run(tiny.cell(name), 2 ** 40 + 3, 0.0, False,
                              torch.device("cpu"), time.perf_counter()))
    assert out["correct"], out["gaps"]
    assert out["gaps"]["loss1"] < 1e-6 and out["gaps"]["grad"] < 1e-5
