"""The decode path: repro_torch's prefill and decode_step against the JAX
package's on the reduced yi-6b, JAX parameters carried over with
`repro_torch.convert`, both sides fed the same numpy tokens.

Tolerances and their reasons:
  * logits 5e-6 abs (their scale is ~1): f32 matmuls and reductions are
    summed in another order by XLA and torch. Measured on these inputs:
    ≤ 4.2e-7 after prefill and after each of 4 decode steps, with either
    cache.
  * f32 cache entries 5e-6 abs (measured ≤ 3.3e-7), quantized scales 5e-6
    relative (measured ≤ 2.1e-7 abs).
  * quantized cache words: the K/V that are quantized differ in their last
    bits, so a value sitting on a bin edge may land in the neighbouring
    code. Every code must be within one bin of JAX's and at most 1% of the
    codes may differ (measured: none).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.dist import step as TS
from repro_torch.models import decode as TD
from repro_torch.models import layers as TL

MAX_SEQ = 24
LOGIT_TOL = 5e-6


@pytest.fixture(scope="module")
def base():
    cfg = jconfigs.get_reduced("yi-6b")
    params = JM.init_params(jax.random.key(0), cfg)
    return cfg, params, convert.from_numpy(jax.tree.map(np.asarray, params))


def _configs(base, bits):
    cfg = jconfigs.get_reduced("yi-6b")
    tcfg = tconfigs.get_reduced("yi-6b")
    if bits:
        cfg = dataclasses.replace(cfg, kv_quant_bits=bits)
        tcfg = dataclasses.replace(tcfg, kv_quant_bits=bits)
    return cfg, tcfg


def _codes(words: np.ndarray, bits: int) -> np.ndarray:
    k = 32 // bits
    w = words[..., None].astype(np.int64) & 0xFFFFFFFF
    return (w >> (np.arange(k) * bits)) & (2 ** bits - 1)


def _compare_caches(jstate, tstate, bits):
    assert set(jstate.caches) == set(tstate.caches)
    np.testing.assert_array_equal(np.asarray(jstate.pos), tstate.pos.numpy())
    for name, jx in jstate.caches.items():
        a, b = np.asarray(jx), tstate.caches[name].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "signs":
            np.testing.assert_array_equal(a, b)
        elif a.dtype == np.int32:
            diff = np.abs(_codes(a, bits) - _codes(b, bits))
            assert diff.max() <= 1, name
            assert (diff > 0).mean() <= 0.01, (name, (diff > 0).sum())
        elif name.endswith("scale"):
            np.testing.assert_allclose(b, a, rtol=5e-6, atol=0)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=5e-6)


@pytest.mark.parametrize("bits", [None, 8], ids=["f32", "quant8"])
def test_prefill_and_decode_steps_match_jax(base, bits):
    _, params, tparams = base
    cfg, tcfg = _configs(base, bits)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, js = jax.jit(lambda p, t: JD.prefill(cfg, p, t, MAX_SEQ))(
        params, jnp.asarray(toks))
    tl, ts = TD.prefill(tcfg, tparams, torch.from_numpy(toks), MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _compare_caches(js, ts, bits)
    jstep = jax.jit(lambda p, s, t: JD.decode_step(cfg, p, s, t))
    tstep = TS.make_serve_step(tcfg)
    tok = np.array(JD.greedy_token(jl))
    np.testing.assert_array_equal(TD.greedy_token(tl).numpy(), tok)
    for _ in range(4):
        jl, js = jstep(params, js, jnp.asarray(tok))
        tl, ts = tstep(tparams, ts, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        tok = np.array(JD.greedy_token(jl))
        np.testing.assert_array_equal(TD.greedy_token(tl).numpy(), tok)
    _compare_caches(js, ts, bits)


def test_ring_prefill_matches_jax(base):
    """A prompt longer than the cache keeps its last C positions at ring
    slots position % C, as the reference's prefill does."""
    _, params, tparams = base
    cfg, tcfg = _configs(base, 8)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 13)).astype(np.int32)
    jl, js = JD.prefill(cfg, params, jnp.asarray(toks), 8)
    tl, ts = TD.prefill(tcfg, tparams, torch.from_numpy(toks), 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    _compare_caches(js, ts, 8)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    k = rng.standard_normal((3, 10, 2, 32)).astype(np.float32)
    v = rng.standard_normal((3, 10, 2, 32)).astype(np.float32)
    lens = np.asarray([0, 4, 10], np.int32)
    for window in (None, 3):
        got = TL.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  kv_len=torch.from_numpy(lens),
                                  window=window)
        want = JL.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   kv_len=jnp.asarray(lens), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("bits", [None, 8], ids=["f32", "quant8"])
@pytest.mark.parametrize("slot_from,slot_to", [(0, 2), (1, 1)])
def test_extract_then_scatter_is_identity(base, bits, slot_from, slot_to):
    """`scatter_slot(init, extract_slot(st, i), j)` reproduces slot i of
    `st` bitwise in slot j, with zeros elsewhere; the extracted state holds
    copies, so writing the source afterwards leaves it unchanged."""
    _, _, tparams = base
    _, tcfg = _configs(base, bits)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (3, 7)).astype(np.int32))
    _, st = TD.prefill(tcfg, tparams, toks, 16)
    single = TD.extract_slot(st, slot_from)
    assert single.caches[("k_words" if bits else "k")].shape[2] == 7
    fresh = TD.init_decode_state(tcfg, 3, 16, device="cpu")
    out = TD.scatter_slot(fresh, single, slot_to)
    for name, x in out.caches.items():
        if name in TD.SHARED_CACHE_KEYS:
            assert torch.equal(x, st.caches[name])
            continue
        assert torch.equal(x[:, slot_to], st.caches[name][:, slot_from])
        others = [i for i in range(3) if i != slot_to]
        assert not x[:, others].any()
    assert int(out.pos[slot_to]) == 7
    before = {n: x.clone() for n, x in single.caches.items()}
    for x in st.caches.values():
        x.add_(1)
    for name, x in single.caches.items():
        if name not in TD.SHARED_CACHE_KEYS:
            assert torch.equal(x, before[name]), name


def test_serve_step_refuses_a_mesh_and_other_blocks(base):
    _, _, tparams = base
    _, tcfg = _configs(base, None)
    assert TS.make_serve_step(tcfg).fn.func is TD.decode_step
    st = TD.init_decode_state(tcfg, 1, 8, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.int32)
    logits, _ = TS.make_serve_step(tcfg, "cpu")(tparams, st, tok)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="serve step on meta"):
        TS.make_serve_step(tcfg, "meta")(tparams, st, tok)
    with pytest.raises(NotImplementedError, match="one device"):
        TS.make_serve_step(tcfg, mesh=("cuda:0", "cuda:1"))
    # the other blocks decode too: an attn_moe state has the reference's
    # leaves, shapes and dtypes (the KV cache only; experts are stateless)
    moe = dataclasses.replace(tcfg, block="attn_moe", num_experts=4)
    jmoe = dataclasses.replace(_configs(base, None)[0], block="attn_moe",
                               num_experts=4)
    tstate = TD.init_decode_state(moe, 1, 8, device="cpu")
    jstate = JD.init_decode_state(jmoe, 1, 8)
    assert set(tstate.caches) == set(jstate.caches) == {"k", "v"}
    for name, jx in jstate.caches.items():
        assert tuple(tstate.caches[name].shape) == jx.shape, name
        assert tstate.caches[name].numpy().dtype == jx.dtype, name
    state_bytes = TD.state_bytes(TD.init_decode_state(
        dataclasses.replace(tcfg, kv_quant_bits=8), 2, 16, device="cpu"))
    # 2 layers × 2 slots × 16 positions × 2 heads × (8 words + 1 scale) ×
    # 4 B × (K and V), plus the 2 positions
    assert state_bytes == 2 * 2 * 16 * 2 * 9 * 4 * 2 + 2 * 4
