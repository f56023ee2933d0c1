"""repro_torch.random (threefry2x32) vs jax.random: bitwise on the draws the
NDSC codec makes. Shared randomness is part of the wire, so every
comparison here is exact equality of the uint32 words / float bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.dist import gradcomp as JG
from repro_torch import random as R
from repro_torch.dist import gradcomp as TG


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_pinned_jax_version():
    """The port reproduces jax 0.9.0's threefry defaults; fail loudly if the
    reference moves."""
    assert jax.__version__ == "0.9.0"
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
@pytest.mark.parametrize("data", [0, 3, 0x5EED, 2 ** 32 - 1])
def test_key_fold_in_split_bitwise(seed, data):
    jk = jax.random.fold_in(jax.random.key(seed), data)
    tk = R.fold_in(R.key(seed), data)
    np.testing.assert_array_equal(_kd(jk), tk.numpy())
    np.testing.assert_array_equal(_kd(jax.random.split(jk)),
                                  R.split(tk).numpy())
    np.testing.assert_array_equal(_kd(jax.random.split(jk, 5)),
                                  R.split(tk, 5).numpy())


@pytest.mark.parametrize("shape", [(1,), (7, 1), (37, 256), (3, 5, 64)])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_uniform_dither_bitwise(shape, bits):
    delta = 2.0 / (2 ** bits)
    jk = jax.random.fold_in(jax.random.key(bits), 1)
    tk = R.fold_in(R.key(bits), 1)
    want = jax.random.uniform(jk, shape, minval=-delta / 2, maxval=delta / 2)
    got = R.uniform(tk, shape, minval=-delta / 2, maxval=delta / 2)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    np.testing.assert_array_equal(
        _bits(jax.random.uniform(jk, shape)), _bits(R.uniform(tk, shape)))


@pytest.mark.parametrize("n", [32, 256, 8192])
def test_rademacher_bitwise(n):
    jk, tk = jax.random.key(5), R.key(5)
    want = jax.random.rademacher(jk, (n,), dtype=jnp.int8)
    np.testing.assert_array_equal(np.asarray(want),
                                  R.rademacher(tk, (n,)).numpy())


def test_random_bits_blocking_is_invisible(monkeypatch):
    """Counters are hashed in blocks to bound memory; the block size must
    not change a draw."""
    tk = R.fold_in(R.key(3), 9)
    whole = R.random_bits32(tk, (40, 33))
    monkeypatch.setattr(R, "_BLOCK", 64)
    np.testing.assert_array_equal(whole.numpy(),
                                  R.random_bits32(tk, (40, 33)).numpy())


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("leaf", [0, 1, 11])
@pytest.mark.parametrize("chunk", [32, 256])
def test_codec_frame_signs_and_stoch_key(seed, leaf, chunk):
    jc = JG.GradCompConfig(chunk=chunk, seed=seed)
    tc = TG.GradCompConfig(chunk=chunk, seed=seed)
    np.testing.assert_array_equal(
        np.asarray(JG._frame_signs(leaf, jc), np.float32),
        TG._frame_signs(leaf, tc, "cpu").numpy())
    np.testing.assert_array_equal(_kd(JG._stoch_key(leaf, 4, jc)),
                                  TG._stoch_key(leaf, 4, tc, "cpu").numpy())


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("keep,exact", [(1.0, False), (0.5, False),
                                        (0.25, True)])
def test_codec_leaf_draws(bits, keep, exact):
    kw = dict(bits=bits, chunk=64, dithered=True, keep_fraction=keep,
              exact_keep=exact)
    jd, jm = JG._leaf_draws(2, 9, 12, JG.GradCompConfig(**kw), 6, None)
    td, tm = TG._leaf_draws(2, 9, 12, TG.GradCompConfig(**kw), 6, None,
                            "cpu")
    np.testing.assert_array_equal(_bits(jd), _bits(td.numpy()))
    if keep < 1.0:
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    else:
        assert jm is None and tm is None
