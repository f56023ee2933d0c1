"""The NDSC-quantized KV cache: repro_torch against the JAX package on the
same numpy inputs, on the CPU (the port's plain versions).

Tolerances and their reasons:
  * `quantize_pack`, `encode_entry` and `head_signs` are held BITWISE: the
    cache's wire format is the reference's (every float step is rounded
    alike, and the signs come from the port's threefry).
  * decode attention to rtol = atol = 2e-4, the bound the JAX package holds
    its Pallas kernel to (tests/test_kvquant.py): exponentials and sums run
    in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantdecode as jqd
from repro.kernels import quantpack as jqp
from repro.kernels import ref as jref
from repro.models import kvquant as jkv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import kvquant as tkv

TOL = 2e-4


def _bits_of(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def _pack_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    # scales above and below the row maxima (the clip acts), one zero row
    # (the tiny guard)
    scale = (np.abs(x).max(-1, keepdims=True)
             * rng.uniform(0.5, 1.5, shape[:-1] + (1,))).astype(np.float32)
    scale.reshape(-1)[1] = 0.0
    return x, scale


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(2, 5, 4, 128), (3, 96), (7, 32)])
def test_quantize_pack_bitwise_vs_jax(bits, shape):
    x, scale = _pack_inputs(shape, sum(shape) + bits)
    got = ops.quantize_pack(torch.from_numpy(x), torch.from_numpy(scale),
                            bits).numpy()
    want_ref = np.asarray(jax.jit(jref.quantize_pack, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(scale), bits))
    want_pallas = np.asarray(jqp.quantize_pack_pallas(
        jnp.asarray(x), jnp.asarray(scale), bits, interpret=True))
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("layer", [0, 1, 2, 7, 31])
@pytest.mark.parametrize("kh,dh", [(4, 128), (2, 32)])
def test_head_signs_bitwise(layer, kh, dh):
    got = tkv.head_signs(0, layer, kh, dh).numpy()
    np.testing.assert_array_equal(got, np.asarray(jkv.head_signs(0, layer,
                                                                 kh, dh)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", [(2, 1, 4, 128), (1, 12, 2, 32)])
def test_encode_entry_bitwise_vs_jitted_jax(bits, shape):
    """Words and scales of the cache entry: the rotation (sign flip + FWHT)
    and the quantizer, equal bit for bit to `kvquant.encode_entry` under
    jax.jit."""
    rng = np.random.default_rng(bits + shape[1])
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    signs = tkv.head_signs(0, 5, shape[2], shape[3])
    words, scale = tkv.encode_entry(torch.from_numpy(x), signs, bits)
    jw, js = jax.jit(jkv.encode_entry, static_argnums=2)(
        jnp.asarray(x), jkv.head_signs(0, 5, shape[2], shape[3]), bits)
    np.testing.assert_array_equal(words.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(_bits_of(scale.numpy()), _bits_of(js))


def _attention_inputs(b, c, kh, g, dh, bits, seed):
    """Pre-scaled queries, packed words over the whole int32 range
    (negative ones included), scales in [0.1, 1.1)."""
    rng = np.random.default_rng(seed)
    wpv = dh * bits // 32
    q = (rng.standard_normal((b, kh, g, dh)) * dh ** -0.5).astype(np.float32)
    kw = rng.integers(-2 ** 31, 2 ** 31, (b, c, kh, wpv), dtype=np.int64)
    vw = rng.integers(-2 ** 31, 2 ** 31, (b, c, kh, wpv), dtype=np.int64)
    ks = (rng.uniform(size=(b, c, kh)) + 0.1).astype(np.float32)
    vs = (rng.uniform(size=(b, c, kh)) + 0.1).astype(np.float32)
    return q, kw.astype(np.int32), ks, vw.astype(np.int32), vs


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("kv_len", [[0, 64], [1, 37], [64, 64]])
def test_plain_decode_attention_vs_pallas_interpret(bits, kv_len):
    """kv_len = 0 gives the uniform mean of V over all C positions in every
    version (all scores are -1e30)."""
    b, c, kh, g, dh = 2, 64, 2, 2, 64
    q, kw, ks, vw, vs = _attention_inputs(b, c, kh, g, dh, bits, bits)
    lens = np.asarray(kv_len, np.int32)
    got = ops.quant_decode_attention(
        *(torch.from_numpy(a) for a in (q, kw, ks, vw, vs, lens)),
        bits=bits).numpy()
    jargs = tuple(jnp.asarray(a) for a in (q, kw, ks, vw, vs, lens))
    pallas = np.asarray(jqd.quant_decode_attention_pallas(
        *jargs, bits=bits, block_c=16, interpret=True))
    want = np.asarray(jref.quant_decode_attention(*jargs, bits=bits))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_all_masked_attention_is_uniform_mean_of_v():
    q, kw, ks, vw, vs = _attention_inputs(1, 8, 1, 2, 32, 8, 3)
    t = [torch.from_numpy(a) for a in (q, kw, ks, vw, vs)]
    out = ops.quant_decode_attention(*t, torch.zeros(1, dtype=torch.int32),
                                     bits=8, inv_rotate_v=False)
    v = tref.unpack_dequant(t[3], t[4][..., None], 8, 32)    # (1, C, 1, dh)
    mean = v.mean(dim=1)[:, :, None, :].expand_as(out)
    torch.testing.assert_close(out, mean, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bits", [4, 8])
def test_kvquant_decode_attention_vs_jax(bits):
    """The model-level function (query scaling and rotation, the attention
    and the inverse sign flip) vs the JAX package's, on its kernel path
    (`use_pallas=True`, interpreted; it needs C % 512 == 0) and its default
    reference path."""
    b, c, kh, g, dh = 2, 512, 2, 4, 64
    rng = np.random.default_rng(11 + bits)
    q = rng.standard_normal((b, 1, kh * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, c, kh, dh)).astype(np.float32)
    v = rng.standard_normal((b, c, kh, dh)).astype(np.float32)
    lens = np.asarray([c, 9], np.int32)
    signs = tkv.head_signs(0, 3, kh, dh)
    kw, ks = tkv.encode_entry(torch.from_numpy(k), signs, bits)
    vw, vs = tkv.encode_entry(torch.from_numpy(v), signs, bits)
    got = tkv.quant_decode_attention(torch.from_numpy(q), (kw, ks, vw, vs),
                                     torch.from_numpy(lens), signs, bits)
    jcache = tuple(jnp.asarray(t.numpy()) for t in (kw, ks, vw, vs))
    jsigns = jkv.head_signs(0, 3, kh, dh)
    for use_pallas in (True, False):
        want = jkv.quant_decode_attention(jnp.asarray(q), jcache,
                                          jnp.asarray(lens), jsigns, bits,
                                          use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
