"""The decode path of the other block families: repro_torch's prefill and
decode_step against the JAX package's on the reduced mixtral (attn_moe),
arctic (attn_moe_dense), hymba (hybrid: KV ring cache + Mamba state) and
xlstm (xlstm_pair: mLSTM and sLSTM states), JAX parameters carried over
with `repro_torch.convert`, both sides fed the same numpy tokens; the
f32 and the 8-bit NDSC KV cache.

Tolerances, as tests/test_torch_decode.py: logits 5e-6 abs; f32 cache
entries and recurrent states 5e-6 abs; quantized scales 5e-6 relative;
quantized codes within one bin of JAX's, at most 1% of them off by one.
The hybrid and xLSTM prefills step decode token by token in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode as JD
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.models import decode as TD

LOGIT_TOL = 5e-6
ARCHS = {"attn_moe": "mixtral-8x22b", "attn_moe_dense": "arctic-480b",
         "hybrid": "hymba-1.5b", "xlstm_pair": "xlstm-350m"}
# (family, KV bits): xlstm_pair has no KV cache
CASES = [(f, b) for f in ARCHS for b in (None, 8)
         if not (f == "xlstm_pair" and b)]
_PARAMS: dict = {}


def _setup(fam, bits, **kw):
    """(JAX cfg, port cfg, JAX params, port params); `kw` replaces config
    fields on both sides (the window, to wrap the ring early)."""
    arch = ARCHS[fam]
    cfg = dataclasses.replace(jconfigs.get_reduced(arch), kv_quant_bits=bits,
                              **kw)
    tcfg = dataclasses.replace(tconfigs.get_reduced(arch),
                               kv_quant_bits=bits, **kw)
    if arch not in _PARAMS:
        params = JM.init_params(jax.random.key(0), cfg)
        _PARAMS[arch] = (params, convert.from_numpy(
            jax.tree.map(np.asarray, params)))
    return (cfg, tcfg) + _PARAMS[arch]


def _codes(words: np.ndarray, bits: int) -> np.ndarray:
    k = 32 // bits
    w = words[..., None].astype(np.int64) & 0xFFFFFFFF
    return (w >> (np.arange(k) * bits)) & (2 ** bits - 1)


def _compare_states(jstate, tstate, bits):
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
            np.testing.assert_allclose(b, a, rtol=0, atol=5e-6, err_msg=name)


def _run_both(cfg, tcfg, params, tparams, prompt, steps, max_seq):
    """Prefill `prompt` then `steps` greedy decode steps in both packages,
    logits compared after each; returns the final states."""
    jl, js = jax.jit(lambda p, t: JD.prefill(cfg, p, t, max_seq))(
        params, jnp.asarray(prompt))
    tl, ts = TD.prefill(tcfg, tparams, torch.from_numpy(prompt), max_seq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=0)
    jstep = jax.jit(lambda p, s, t: JD.decode_step(cfg, p, s, t))
    for _ in range(steps):
        tok = np.array(JD.greedy_token(jl))
        np.testing.assert_array_equal(TD.greedy_token(tl).numpy(), tok)
        jl, js = jstep(params, js, jnp.asarray(tok))
        tl, ts = TD.decode_step(tcfg, tparams, ts, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
    return js, ts


@pytest.mark.parametrize("fam,bits", CASES)
def test_prefill_and_decode_steps_match_jax(fam, bits):
    cfg, tcfg, params, tparams = _setup(fam, bits)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    js, ts = _run_both(cfg, tcfg, params, tparams, prompt, 3, 20)
    _compare_states(js, ts, bits)


@pytest.mark.parametrize("fam,bits", [("attn_moe", 8), ("attn_moe", None),
                                      ("hybrid", 8)])
def test_ring_cache_past_the_window_matches_jax(fam, bits):
    """A window of 8: the 10-token prompt already wraps the ring (the
    attention families keep its last 8 positions at slots p % 8; the
    hybrid prefill steps decode through the wrap), then 4 decode steps
    overwrite more slots."""
    cfg, tcfg, params, tparams = _setup(fam, bits, window=8)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 10)).astype(np.int32)
    js, ts = _run_both(cfg, tcfg, params, tparams, prompt, 4, 32)
    assert int(ts.pos[0]) == 14
    assert ts.caches["k_words" if bits else "k"].shape[2] == 8
    _compare_states(js, ts, bits)


@pytest.mark.parametrize("fam,bits", CASES)
@pytest.mark.parametrize("slot_from,slot_to", [(0, 2), (1, 1)])
def test_extract_then_scatter_is_identity(fam, bits, slot_from, slot_to):
    """`scatter_slot(init, extract_slot(st, i), j)` reproduces slot i of
    `st` bitwise in slot j, zeros elsewhere, for positional leaves (trimmed
    to the prompt) and for the per-slot, position-free recurrent states
    (copied whole); the extracted state holds copies."""
    _, tcfg, _, tparams = _setup(fam, bits)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (3, 7)).astype(np.int32))
    _, st = TD.prefill(tcfg, tparams, toks, 16)
    single = TD.extract_slot(st, slot_from)
    fresh = TD.init_decode_state(tcfg, 3, 16, device="cpu")
    for name, x in single.caches.items():
        if name in TD.POSITIONAL_CACHE_KEYS:
            assert x.shape[2] == 7
        elif name not in TD.SHARED_CACHE_KEYS:
            assert x.shape == (st.caches[name].shape[:1] + (1,)
                               + st.caches[name].shape[2:]), name
    init_leaves = {n: x.clone() for n, x in fresh.caches.items()}
    out = TD.scatter_slot(fresh, single, slot_to)
    recurrent = set(out.caches) - TD.POSITIONAL_CACHE_KEYS \
        - TD.SHARED_CACHE_KEYS
    if fam in ("hybrid", "xlstm_pair"):
        assert recurrent
    for name, x in out.caches.items():
        if name in TD.SHARED_CACHE_KEYS:
            assert torch.equal(x, st.caches[name])
            continue
        assert torch.equal(x[:, slot_to], st.caches[name][:, slot_from]), name
        others = [i for i in range(3) if i != slot_to]
        assert torch.equal(x[:, others], init_leaves[name][:, others]), name
    assert int(out.pos[slot_to]) == 7
    before = {n: x.clone() for n, x in single.caches.items()}
    for x in st.caches.values():
        x.add_(1)
    for name, x in single.caches.items():
        if name not in TD.SHARED_CACHE_KEYS:
            assert torch.equal(x, before[name]), name


@pytest.mark.parametrize("fam", ["hybrid", "xlstm_pair", "attn_moe"])
def test_engine_prefix_contract_holds(fam):
    """A prefix hit and a cold admission give bitwise the same slot state
    (recurrent leaves included) and greedy tokens."""
    _, tcfg, _, tparams = _setup(fam, 8 if fam != "xlstm_pair" else None)
    rng = np.random.default_rng(6)
    prefix = torch.from_numpy(rng.integers(0, tcfg.vocab_size, 6)
                              .astype(np.int32))
    prompt = torch.from_numpy(rng.integers(0, tcfg.vocab_size, 3)
                              .astype(np.int32))
    out = tserve.verify_prefix_contract(
        tcfg, tparams, tserve.ServeConfig(slots=2, max_seq=24), prefix,
        prompt, max_new_tokens=3, device="cpu")
    assert out


def test_encoder_has_no_decode():
    tcfg = tconfigs.get_reduced("hubert-xlarge")
    assert not tcfg.decode_supported
    with pytest.raises(ValueError, match="encoder-only"):
        TD.init_decode_state(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        TD.prefill(tcfg, {}, torch.zeros((1, 2), dtype=torch.int32), 8)
