"""repro_torch.core (quantizers, frames, embeddings, coding, baselines) vs
repro.core, eager, on the same numpy inputs and keys.

Contract: integer payloads, keep masks, frame signs and rows, and every
quantized value bitwise; Hadamard frames bitwise (the FWHT is); dense
frames, the democratic embedding and sum-scaled compressors to the stated
tolerance. The reference's algorithms run their codec under `jit`, where
XLA turns `x / const` into a reciprocal multiply, so the codec-level
contract is with the EAGER reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as JB
from repro.core import coding as JC
from repro.core import embeddings as JE
from repro.core import frames as JF
from repro.core import quantizers as JQ
from repro.data import pipeline as JD
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import baselines as TB
from repro_torch.core import coding as TC
from repro_torch.core import embeddings as TE
from repro_torch.core import frames as TF
from repro_torch.core import quantizers as TQ
from repro_torch.data import pipeline as TP


def _kd(k):
    return torch.from_numpy(
        np.asarray(jax.random.key_data(k)).astype(np.int64))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_bits(want, got: torch.Tensor):
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.numpy())
    assert want.shape == got.shape and want.dtype == got.dtype
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def _inputs(n=1000, seed=0):
    """±1, 0, the floats next to ±1, values beyond ±1 and random ones."""
    rng = np.random.default_rng(seed)
    edge = [1.0, -1.0, 0.0, -0.0, 1.5, -2.5, 0.99999994, -0.99999994]
    return np.concatenate([edge, rng.standard_normal(n) * 0.7]).astype(
        np.float32)


def _hadamard_pair(key, n, N):
    jf = JF.hadamard_frame(key, n, N)
    return jf, convert.frame_from_numpy(
        "hadamard", {"signs": jf.signs, "rows": jf.rows})


# -- quantizers ----------------------------------------------------------------
@pytest.mark.parametrize("levels", [2, 3, 15, 16, 255, 256])
def test_quantizers_bitwise(levels):
    x = _inputs()
    xj, xt = jnp.asarray(x), _t(x)
    _same_bits(JQ.uniform_quantize(xj, levels), TQ.uniform_quantize(xt, levels))
    idx = JQ.quantize_indices(xj, levels)
    _same_bits(idx, TQ.quantize_indices(xt, levels))
    _same_bits(JQ.dequantize_indices(idx, levels),
               TQ.dequantize_indices(_t(idx), levels))
    k = jax.random.key(levels)
    _same_bits(JQ.dithered_quantize(k, xj, levels),
               TQ.dithered_quantize(_kd(k), xt, levels))
    didx = JQ.dithered_quantize_indices(k, xj, levels)
    _same_bits(didx, TQ.dithered_quantize_indices(_kd(k), xt, levels))
    _same_bits(JQ.dithered_dequantize_indices(didx, levels),
               TQ.dithered_dequantize_indices(_t(didx), levels))
    assert JQ.levels_for_budget(np.log2(levels)) == TQ.levels_for_budget(
        np.log2(levels))


@pytest.mark.parametrize("dynamic_range", [4.0, "tensor"])
def test_gain_quantize_and_mask_bitwise(dynamic_range):
    """At 32 bits levels − 1 = 2^31 − 1 rounds to 2^31 in f32 on both sides;
    a tensor range divides in f32, a float one in double, as the
    reference does."""
    v = np.abs(_inputs())
    k = jax.random.key(9)
    jr = jnp.float32(3.0) if dynamic_range == "tensor" else dynamic_range
    tr = torch.tensor(3.0) if dynamic_range == "tensor" else dynamic_range
    _same_bits(JQ.gain_quantize(k, jnp.asarray(v), jr),
               TQ.gain_quantize(_kd(k), _t(v), tr))
    _same_bits(JQ.gain_quantize(k, jnp.asarray(v), jr, bits=8),
               TQ.gain_quantize(_kd(k), _t(v), tr, bits=8))
    _same_bits(JQ.subsample_mask(k, (50, 7), 0.3),
               TQ.subsample_mask(_kd(k), (50, 7), 0.3))


# -- frames ----------------------------------------------------------------------
@pytest.mark.parametrize("n,N", [(30, 32), (116, 128), (1000, 1024),
                                 (128, 128)])
def test_hadamard_frame_bitwise(n, N):
    """Signs and rows drawn bitwise (the permutation path for n < N), and
    S x, Sᵀ y bitwise; dense_matrix bitwise where it is small."""
    key = jax.random.key(n)
    jf = JF.hadamard_frame(key, n, N)
    tf = TF.hadamard_frame(_kd(key), n, N)
    _same_bits(jf.signs, tf.signs)
    _same_bits(jf.rows, tf.rows)
    assert (tf.n, tf.N, tf.aspect_ratio) == (jf.n, jf.N, jf.aspect_ratio)
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, N)).astype(np.float32)
    y = rng.standard_normal((3, n)).astype(np.float32)
    # jitted: one compile, not one per eager op (FWHT, signs and gather
    # have no division for XLA to rewrite)
    _same_bits(jax.jit(jf.apply)(jnp.asarray(x)), tf.apply(_t(x)))
    _same_bits(jax.jit(jf.apply_t)(jnp.asarray(y)), tf.apply_t(_t(y)))
    if N <= 128:
        _same_bits(jax.jit(JF.dense_matrix)(jf), TF.dense_matrix(tf))


def test_dense_frames():
    """DenseFrame on the reference's S within 1e-6 relative (1.2e-7
    observed); the port's own Haar frame is orthonormal (‖S Sᵀ − I‖∞ ≤
    1e-5; 4.5e-7 observed) and its sub-Gaussian frame near Parseval."""
    jf = JF.haar_frame(jax.random.key(5), 40, 64)
    tf = convert.frame_from_numpy("dense", {"S": jf.S})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    y = rng.standard_normal((4, 40)).astype(np.float32)
    for want, got in ((jf.apply(jnp.asarray(x)), tf.apply(_t(x))),
                      (jf.apply_t(jnp.asarray(y)), tf.apply_t(_t(y)))):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 1e-6 * np.linalg.norm(
            want)
    for n, N in ((40, 64), (116, 116), (500, 1000)):
        S = TF.make_frame("haar", R.key(n), n, N).S.double()
        assert S.shape == (n, N)
        assert float((S @ S.T - torch.eye(n, dtype=torch.float64)).abs()
                     .max()) <= 1e-5
    G = TF.make_frame("subgaussian", R.key(2), 64, 4096).S.double()
    assert float((G @ G.T - torch.eye(64, dtype=torch.float64)).abs()
                 .max()) <= 0.1
    with pytest.raises(ValueError, match="power of 2"):
        TF.hadamard_frame(R.key(0), 30, 48)
    with pytest.raises(ValueError, match="unknown"):
        TF.make_frame("fourier", R.key(0), 8)


# -- embeddings ------------------------------------------------------------------
@pytest.mark.parametrize("n,N", [(116, 116), (500, 1000)])
def test_democratic_embedding(n, N):
    """LV truncation on the reference's Haar S: within 1e-5 relative ℓ2
    (1.9e-7 and 3.4e-7 observed), y = S x to f32 precision, and the Kashin
    bound ‖x‖∞ ≤ K_u‖y‖₂/√N."""
    jf = JF.haar_frame(jax.random.key(1), n, N)
    tf = convert.frame_from_numpy("dense", {"S": jf.S})
    y = (np.random.default_rng(n).standard_normal((2, n)) ** 3).astype(
        np.float32)
    want = np.asarray(JE.democratic(jf, jnp.asarray(y)))
    got = TE.democratic(tf, _t(y))
    assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    np.testing.assert_allclose(tf.apply(got).numpy(), y, rtol=0, atol=1e-4)
    ku = TE.kashin_constant_upper()
    assert ku == JE.kashin_constant_upper()
    bound = ku * np.linalg.norm(y, axis=-1) / np.sqrt(N)
    assert (np.abs(got.numpy()).max(axis=-1) <= bound).all()
    np.testing.assert_array_equal(
        TE.EmbeddingSpec().embed(tf, _t(y)).numpy(), tf.apply_t(_t(y)).numpy())


# -- coding ----------------------------------------------------------------------
@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("dithered", [False, True])
@pytest.mark.parametrize("bits", [4.0, 0.5])
def test_codec_payload_bitwise(N, dithered, bits):
    """Indices, scale and mask bitwise with a Hadamard frame at aspect 1
    and 2 in all four modes; decode within 1e-6 (0.0 observed);
    wire_bits and error_bound equal."""
    jf, tf = _hadamard_pair(jax.random.key(3), 64, N)
    cfg = dict(bits_per_dim=bits, dithered=dithered)
    jc = JC.Codec(jf, JC.CodecConfig(**cfg))
    tc = TC.Codec(tf, TC.CodecConfig(**cfg))
    y = (np.random.default_rng(2).standard_normal((4, 64)) ** 3).astype(
        np.float32)
    k = jax.random.key(11)
    jp = jc.encode(jnp.asarray(y), k)
    tp = tc.encode(_t(y), _kd(k))
    _same_bits(jp.indices, tp.indices)
    _same_bits(jp.scale, tp.scale)
    assert (jp.mask is None) == (tp.mask is None)
    if jp.mask is not None:
        _same_bits(jp.mask, tp.mask)
    np.testing.assert_allclose(tc.decode(tp).numpy(),
                               np.asarray(jc.decode(jp)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.roundtrip(_t(y), _kd(k)).numpy(),
                                  tc.decode(tp).numpy())
    assert tc.wire_bits() == jc.wire_bits()
    assert tc.error_bound() == jc.error_bound()
    assert (tc.levels, tc.keep_fraction) == (jc.levels, jc.keep_fraction)


def test_codec_rows_under_a_key_stack():
    """A batch of rows under a stack of keys encodes row i as row i alone
    under key i (Algorithm 3's workers), and a randomized mode refuses to
    run without a key; so do the randomized baselines."""
    _, tf = _hadamard_pair(jax.random.key(3), 30, 32)
    tc = TC.Codec(tf, TC.CodecConfig(bits_per_dim=0.5, dithered=True))
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 30)).astype(np.float32))
    keys = R.split(R.key(6), 5)
    batch = tc.encode(y, keys)
    for i in range(5):
        row = tc.encode(y[i], keys[i])
        for a, b in zip(batch, row):
            np.testing.assert_array_equal(a[i].numpy(), b.numpy())
    with pytest.raises(ValueError, match="key"):
        tc.encode(y)
    for comp in (TB.standard_dither(2), TB.randk(0.5, 2, unbiased=True),
                 TB.ternary()):
        batch = comp.roundtrip(keys, y)
        for i in range(5):
            np.testing.assert_array_equal(batch[i].numpy(),
                                          comp.roundtrip(keys[i], y[i]).numpy())


def test_compress_in_embedded_space():
    jf, tf = _hadamard_pair(jax.random.key(2), 100, 128)
    y = (np.random.default_rng(4).standard_normal(100) ** 3).astype(
        np.float32)
    k = jax.random.key(5)
    want = JC.compress_in_embedded_space(
        jf, JB.standard_dither(8).roundtrip, jnp.asarray(y), k)
    got = TC.compress_in_embedded_space(
        tf, TB.standard_dither(8).roundtrip, _t(y), _kd(k))
    _same_bits(want, got)


# -- baselines -------------------------------------------------------------------
_MAX_SCALED = {
    "naive": lambda m: m.naive_uniform(16),
    "standard_dither": lambda m: m.standard_dither(16),
    "ternary": lambda m: m.ternary(),
    "topk": lambda m: m.topk(0.1),
    "topk_q": lambda m: m.topk(0.1, 32),
    "randk": lambda m: m.randk(0.3),
    "randk_q_unbiased": lambda m: m.randk(0.5, 2, unbiased=True),
    "sign": lambda m: m.sign_compressor(scaled=False),
}
_SUM_SCALED = {"qsgd": lambda m: m.qsgd(4),
               "sign_l1": lambda m: m.sign_compressor()}


@pytest.mark.parametrize("name", sorted(_MAX_SCALED) + sorted(_SUM_SCALED))
def test_baselines(name):
    """Bitwise where the scale is a max; where it is a sum (ℓ2 or ℓ1, summed
    in another order) within 1e-6 relative to ‖y‖∞ (1e-7 observed).
    Name and wire audit equal."""
    make = {**_MAX_SCALED, **_SUM_SCALED}[name]
    jb, tb = make(JB), make(TB)
    y = (np.random.default_rng(5).standard_normal((5, 100)) ** 3).astype(
        np.float32)
    k = jax.random.key(4)
    want = jb.roundtrip(k, jnp.asarray(y))
    got = tb.roundtrip(_kd(k), _t(y))
    if name in _MAX_SCALED:
        _same_bits(want, got)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * np.abs(y).max())
    assert tb.name == jb.name
    assert tb.wire_bits(100) == jb.wire_bits(100)
    np.testing.assert_allclose(
        TB.normalized_error(_kd(k), tb, _t(y)).numpy(),
        np.asarray(JB.normalized_error(k, jb, jnp.asarray(y))), rtol=1e-5)


# -- data and conversion ---------------------------------------------------------
def test_synthetic_problems():
    """The §5 generators: the reference's shapes and planted structure
    (b = A x*, labels ±1 with the classes' means at ±separation/√dim), a
    pure function of the seed. Their draws are not the reference's (a
    torch.Generator, not threefry), so parity tests carry arrays across."""
    a, b, x = TP.synthetic_regression(3, 40, 12, device="cpu")
    assert (a.shape, b.shape, x.shape) == ((40, 12), (40,), (12,))
    np.testing.assert_allclose(b.numpy(), (a @ x).numpy(), rtol=1e-6)
    a2, _, x2 = TP.synthetic_regression(3, 40, 12, device="cpu")
    assert torch.equal(a, a2) and torch.equal(x, x2)
    for design, model in (("gauss", "gauss3"), ("gauss3", "gauss")):
        ja, _, jx = JD.synthetic_regression(jax.random.key(0), 40, 12,
                                            design, model)
        ta, _, tx = TP.synthetic_regression(0, 40, 12, design, model,
                                         device="cpu")
        assert ta.shape == ja.shape and tx.shape == jx.shape
    xs, ys = TP.synthetic_two_class(1, 500, 16, separation=2.0,
                                     device="cpu")
    assert xs.shape == (1000, 16)
    np.testing.assert_array_equal(ys.numpy(), np.r_[np.ones(500),
                                                    -np.ones(500)])
    mean_gap = (xs[:500].mean(0) - xs[500:].mean(0)).numpy()
    np.testing.assert_allclose(mean_gap, 2 * 2.0 / np.sqrt(16), atol=0.3)
    with pytest.raises(ValueError, match="unknown frame kind"):
        convert.frame_from_numpy("haar", {"S": np.eye(2)})
