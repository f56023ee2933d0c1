"""Mellum2-12B-A2.5B in the port: sliding and full attention layers in
one stack, YaRN on the full ones, 64 experts top-8 (reduced here).

The port's loss and every gradient leaf against the benchmark's plain
reference (`bench/reference/layer_types.py`, no JAX) at a toy width; the
blockwise attention's skipped block pairs against the loop that computes
every pair; the YaRN table against its closed formula; the decode path's
refusal; the sublayer marks and obs counters; and the reduced model
through the captured train step."""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import train_layer_types, weights  # noqa: E402
from bench.reference import layer_types as ref  # noqa: E402
from repro_torch import configs, obs  # noqa: E402
from repro_torch.kernels import marks  # noqa: E402
from repro_torch.models import decode as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

NAME = "mellum2-12b-a2.5b"
PERIOD = ["sliding_attention"] * 3 + ["full_attention"]


def _file(seq_window=300, factor=4.0, original=256):
    """A configuration file in the benchmark's keys at a toy width: one
    period of layers, a window shorter than the sequence, 8 experts top-4,
    YaRN on the full layer from `original` positions."""
    return {
        "name": "mellum2-tiny", "hidden_size": 64, "head_dim": 16,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "intermediate_size": 256, "moe_intermediate_size": 32,
        "num_experts": 8, "num_experts_per_tok": 4, "num_hidden_layers": 4,
        "layer_types": PERIOD * 2, "sliding_window": seq_window,
        "vocab_size": 256, "rms_norm_eps": 1e-6, "capacity_factor": 1.25,
        "router_aux_loss_coef": 0.001, "initializer_range": 0.02,
        "rope_parameters": {
            "full_attention": {
                "rope_type": "yarn", "rope_theta": 10000.0,
                "factor": factor, "original_max_position_embeddings":
                original, "beta_fast": 32, "beta_slow": 1},
            "sliding_attention": {"rope_type": "default",
                                  "rope_theta": 10000.0}}}


def test_registry_keeps_the_references_ten():
    assert NAME not in configs.ARCH_NAMES and len(configs.ARCH_NAMES) == 10
    assert NAME in configs.PORT_NAMES and NAME in configs.ALL_NAMES
    cfg = configs.get(NAME)
    assert (cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff) == (
        2304, 4096, 512, 896)
    assert (cfg.num_experts, cfg.top_k, cfg.window) == (64, 8, 1024)
    assert [cfg.layer_kind(i) for i in range(8)] == [
        "sliding", "sliding", "sliding", "full"] * 2
    assert cfg.layer_rope(3).factor == 16.0 and cfg.layer_rope(0).factor \
        is None
    assert cfg.mixed_layers and not cfg.subquadratic
    assert cfg.window_or_none(0) == 1024 and cfg.window_or_none(3) is None
    # the ten keep their one kind and plain table
    yi = configs.get("yi-6b")
    assert yi.layer_rope(5) == M.RopeSpec(yi.rope_theta)
    assert not yi.mixed_layers and yi.decode_supported


def test_loss_and_every_gradient_leaf_match_the_reference():
    """1 row of 1,100 positions: three query blocks of 512 and two kv
    blocks of 1,024 in the port, so block pairs are skipped (causal and
    beyond the window of 300). Tolerances: the loss within 2e-6 relative
    and each gradient leaf within 2e-5 of its largest value (plus 1e-9
    absolute): the two sides sum in different orders (online softmax by
    blocks against one softmax over the allowed keys; the LM head's loss
    by chunks of 512 against whole), f32 round-off of a few ulps per sum,
    far below what TF32 products move (tests of `bench/tests`)."""
    cfg = train_layer_types.weights_cfg(_file())
    mcfg = train_layer_types.model_config(cfg)
    assert mcfg.layer_types == ("sliding",) * 3 + ("full",)
    params = weights.make_params(cfg, 7, "cpu")
    tokens = weights.token_rows(cfg, 7, 1, 1, 1100, "cpu")[0]
    leaves = weights.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    want = ref.loss(cfg, params, tokens)
    got = M.loss_fn(mcfg, params, {"tokens": tokens})
    assert abs(float(got.detach()) - float(want.detach())) <= 2e-6 * abs(
        float(want.detach()))
    g_want = torch.autograd.grad(want, leaves)
    g_got = torch.autograd.grad(got, leaves)
    for name, a, b in zip(weights.leaf_names(cfg), g_got, g_want):
        tol = 2e-5 * float(b.abs().max()) + 1e-9
        assert float((a - b).abs().max()) <= tol, name


def _unskipped(monkeypatch):
    """blockwise_attention as it was: every (q, kv) pair computed."""
    monkeypatch.setattr(L, "block_pairs", lambda sq, skv, *, causal,
                        window=None, block_q=512, block_kv=1024: [
        list(range(-(-skv // block_kv)))] * (-(-sq // block_q)))


@pytest.mark.parametrize("sq,window", [(256, None), (256, 40), (200, None),
                                       (200, 40), (230, 100)])
def test_skipping_block_pairs_gives_the_same_numbers(sq, window,
                                                     monkeypatch):
    """Causal, windowed and padded lengths (200, 230 pad to blocks of 32
    and 64): the output and the gradients of q, k, v are bitwise those of
    the loop over every pair."""
    g = torch.Generator().manual_seed(sq + (window or 0))
    q, k, v = (torch.randn(2, sq, h, 16, generator=g) for h in (4, 2, 2))

    def attend():
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out = L.blockwise_attention(qq, kk, vv, causal=True, window=window,
                                    block_q=32, block_kv=64)
        grads = torch.autograd.grad((out * out).sum(), (qq, kk, vv))
        return out.detach(), grads

    pairs = L.block_pairs(sq, sq, causal=True, window=window, block_q=32,
                          block_kv=64)
    every = -(-sq // 32) * -(-sq // 64)
    assert sum(len(p) for p in pairs) < every
    out, grads = attend()
    _unskipped(monkeypatch)
    out0, grads0 = attend()
    assert torch.equal(out, out0)
    for a, b in zip(grads, grads0):
        assert torch.equal(a, b)


def test_block_pairs_at_the_published_length():
    """8,192 positions in blocks of 512 × 1,024: 72 of 128 pairs hold a
    causal position, 30 a position within a window of 1,024."""
    full = L.block_pairs(8192, 8192, causal=True)
    sliding = L.block_pairs(8192, 8192, causal=True, window=1024)
    assert sum(map(len, full)) == 72 and sum(map(len, sliding)) == 30
    assert sum(map(len, L.block_pairs(8192, 8192, causal=False))) == 128


def _yarn_formula(dh, theta, factor, original, beta_fast, beta_slow):
    """The YaRN table in float64 from the closed formula."""
    def d(rot):
        return dh * math.log(original / (2 * math.pi * rot)) / (
            2 * math.log(theta))

    low, high = math.floor(d(beta_fast)), math.ceil(d(beta_slow))
    i = np.arange(dh // 2, dtype=np.float64)
    f = theta ** (-2.0 * i / dh)
    gamma = np.clip((i - low) / (high - low), 0.0, 1.0)
    return gamma * f / factor + (1.0 - gamma) * f, low, high


def test_yarn_table_against_the_closed_formula():
    """At the published sizes the ramp runs from pair 18 (⌊18.08⌋) to 35
    (⌈34.98⌉); the f32 table is the f64 formula rounded once (within half
    an ulp, 2^-24 relative), the plain table below the ramp's start, f/16
    above its end; the scale is the given attention factor. The sliding
    layers' plain table is rounded once from f64 too."""
    rope = configs.get(NAME).layer_rope(3)
    assert L.yarn_range(128, rope) == (18, 35)
    want, low, high = _yarn_formula(128, 500000.0, 16.0, 8192, 32, 1)
    assert (low, high) == (18, 35)
    got, scale = L.rope_table(128, rope)
    assert scale == 1.2772588722239782
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want, rtol=2 ** -24)
    plain = 500000.0 ** (-np.arange(0, 128, 2, dtype=np.float64) / 128)
    np.testing.assert_allclose(got[:19].double().numpy(), plain[:19],
                               rtol=2 ** -24)
    np.testing.assert_allclose(got[35:].double().numpy(), plain[35:] / 16,
                               rtol=2 ** -24)
    sliding, none = L.rope_table(128, configs.get(NAME).layer_rope(0))
    assert none is None
    np.testing.assert_allclose(sliding.double().numpy(), plain,
                               rtol=2 ** -24)
    # the reference's table, in float64 from the file's keys
    cfg = {"head_dim": 128, "rope_parameters": {"full_attention": {
        "rope_type": "yarn", "rope_theta": 500000, "factor": 16,
        "original_max_position_embeddings": 8192, "beta_fast": 32,
        "beta_slow": 1, "attention_factor": 1.2772588722239782}}}
    f, a = ref.rope_table(cfg, "full")
    np.testing.assert_allclose(f.numpy(), want, rtol=1e-15)
    assert a == 1.2772588722239782
    # the default attention factor, 0.1 ln(factor) + 1
    assert L.yarn_attention_factor(dataclasses.replace(
        rope, attention_factor=None)) == pytest.approx(
            0.1 * math.log(16) + 1, rel=1e-15)


def test_yarn_scale_multiplies_the_logits_by_its_square():
    """apply_rope with a scale a rotates as without it, times a: q·k then
    scales by a². Within 1e-6 absolute on O(1) inputs: the scale rounds
    cos and sin once more before the products (a few ulps at 1)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1, 5, 2, 16, generator=g)
    pos = torch.arange(5)[None]
    freqs, none = L.rope_table(16, M.RopeSpec(100.0))
    assert none is None
    plain = L.apply_rope(x, pos, freqs)
    scaled = L.apply_rope(x, pos, freqs, 1.5)
    torch.testing.assert_close(scaled, 1.5 * plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("call", ["init", "specs", "prefill", "step"])
def test_decode_refuses_mixed_layer_types(call):
    cfg = configs.get_reduced(NAME)
    assert not cfg.decode_supported
    params = M.init_params(0, cfg, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="mixed layer types"):
        if call == "init":
            D.init_decode_state(cfg, 1, 16, device="cpu")
        elif call == "specs":
            D.decode_state_specs(cfg, 1, 16)
        elif call == "prefill":
            D.prefill(cfg, params, tokens, 16)
        else:
            state = D.init_decode_state(
                dataclasses.replace(cfg, layer_types=None), 1, 16,
                device="cpu")
            D.decode_step(cfg, params, state, tokens[:, :1])


def test_forward_marks_its_sublayers_and_counts_its_pairs(monkeypatch):
    """Each layer marks its attention by kind and its MoE, then the head;
    an obs session counts the block pairs computed and skipped by kind and
    the MoE's capacity and slots."""
    seen = []
    monkeypatch.setattr(marks, "sublayer",
                        lambda name, like: seen.append(name))
    cfg = configs.get_reduced(NAME)
    params = M.init_params(0, cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 1101),
                           generator=torch.Generator().manual_seed(1))
    session = obs.enable()
    try:
        with torch.no_grad():
            M.loss_fn(cfg, params, {"tokens": tokens})
    finally:
        obs.disable()
    assert seen == ["attn_sliding", "moe"] * 3 + ["attn_full", "moe",
                                                   "head"]
    c = session.summary()["counters"]
    # 1,100 positions: 3 query blocks × 2 kv blocks; window 48
    assert c["attn.full.pairs_computed"]["total"] == 4
    assert c["attn.full.pairs_skipped"]["total"] == 2
    assert c["attn.sliding.pairs_computed"]["total"] == 3 * 4
    assert c["attn.sliding.pairs_skipped"]["total"] == 3 * 2
    cap = int(1.25 * 1100 * 4 / 8)
    assert c["moe.capacity"]["total"] == 4 * cap
    assert c["moe.slots"]["total"] == 4 * 8 * cap
    assert set(marks.SUBPHASES) == {"attn_sliding", "attn_full", "moe",
                                    "head"}
    assert not set(marks.SUBPHASES) & set(marks.PHASES)


def test_reduced_model_trains_through_the_captured_step():
    """make_train_step (the captured program's path on the CPU) with the
    NDSC codec and AdamW: two steps, a finite loss, and the weights
    moved."""
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import step as S
    from repro_torch.optimizer import optim

    cfg = configs.get_reduced(NAME)
    gc = G.GradCompConfig(bits=4, chunk=256)
    opt = optim.adamw(3e-4, weight_decay=0.1)
    step = S.make_train_step(cfg, opt, gc, clip_norm=1.0)
    state = S.init_train_state(cfg, opt, gc, device="cpu")
    before = state[0]["blocks"]["wq"].clone()
    toks = torch.randint(0, cfg.vocab_size, (2, 97),
                         generator=torch.Generator().manual_seed(2))
    for _ in range(2):
        *state, met = step(*state, {"tokens": toks})
        assert math.isfinite(float(met["loss"]))
    assert not torch.equal(state[0]["blocks"]["wq"], before)
