"""repro_torch.random (threefry2x32) vs jax.random: bitwise on the draws the
NDSC codec makes. Shared randomness is part of the wire, so every
comparison here is exact equality of the uint32 words / float bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("n", [1, 2, 32, 116, 128, 1024, 1625, 1626, 8192])
def test_permutation_bitwise(n):
    """One sorting round up to n = 1625, two from 1626: both sides."""
    for seed in (0, 7):
        want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
        got = R.permutation(R.key(seed), n).numpy()
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 4), (0, 10), (-40, 60),
                                   (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
                                   (3, 3), (5, -2)])
def test_randint_bitwise(lo, hi):
    """Spans 1, 4, 10, 100, 2^31 − 1 and 2^32 − 1 (the multiplier wraps in
    uint32 there), and maxval ≤ minval (→ minval)."""
    jk = jax.random.fold_in(jax.random.key(3), 8)
    want = np.asarray(jax.random.randint(jk, (37, 5), lo, hi))
    got = R.randint(R.fold_in(R.key(3), 8), (37, 5), lo, hi).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(want, got)


def test_key_stack_rows_equal_single_key_draws():
    """A stack of keys (m, 2) draws row i bitwise as key i alone (and as
    jax.vmap over the keys); so do nested stacks and splits."""
    jks = jax.random.split(jax.random.key(1), 6)
    tks = R.split(R.key(1), 6)
    want = jax.vmap(lambda k: jax.random.uniform(k, (33,)))(jks)
    np.testing.assert_array_equal(_bits(want), _bits(R.uniform(tks, (6, 33))))
    for i in range(6):
        np.testing.assert_array_equal(_bits(R.uniform(tks[i], (33,))),
                                      _bits(R.uniform(tks, (6, 33))[i]))
    want = jax.vmap(lambda k: jax.random.randint(k, (4,), 0, 10))(jks)
    np.testing.assert_array_equal(np.asarray(want),
                                  R.randint(tks, (6, 4), 0, 10).numpy())
    np.testing.assert_array_equal(_kd(jax.vmap(jax.random.split)(jks)),
                                  R.split(tks).numpy())
    nested = R.split(tks.reshape(2, 3, 2), 4)
    np.testing.assert_array_equal(nested[1, 2].numpy(),
                                  R.split(tks[5], 4).numpy())
    with pytest.raises(ValueError, match="start with"):
        R.uniform(tks, (5, 33))


def test_step_keys_draw_as_their_keys():
    """A KeyStack's step keys draw (and split) bitwise as the keys they
    stand for, each draw made once for every step."""
    keys = R.split(R.key(4), 5)
    stack = R.KeyStack(keys)
    for t in range(5):
        k = stack.at(t)
        a, b = R.split2(k)
        want_a, want_b = R.split2(keys[t])
        np.testing.assert_array_equal(a.value.numpy(), want_a.numpy())
        np.testing.assert_array_equal(_bits(R.uniform(b, (7,))),
                                      _bits(R.uniform(want_b, (7,))))
        np.testing.assert_array_equal(R.randint(a, (3,), 0, 9).numpy(),
                                      R.randint(want_a, (3,), 0, 9).numpy())
        w = R.split(k, 3)
        np.testing.assert_array_equal(
            _bits(R.uniform(w, (3, 8))), _bits(R.uniform(R.split(keys[t], 3),
                                                          (3, 8))))
        np.testing.assert_array_equal(
            R.permutation(k, 40).numpy(), R.permutation(keys[t], 40).numpy())
    n_memo = len(stack._memo)
    R.uniform(R.split2(stack.at(0))[1], (7,))
    assert len(stack._memo) == n_memo       # a second step reuses the draw


def test_step_key_draw_blocks_are_invisible(monkeypatch):
    """A KeyStack draws ahead for a block of steps, bounded in size; the
    block size must not change a draw."""
    keys = R.split(R.key(8), 9)
    monkeypatch.setattr(R, "_DRAW_BLOCK", 20)      # 2 steps of (2, 5)
    stack = R.KeyStack(keys)
    for t in (0, 1, 2, 8, 3):
        np.testing.assert_array_equal(
            _bits(R.uniform(stack.at(t), (2, 5))),
            _bits(R.uniform(keys[t], (2, 5))))
        np.testing.assert_array_equal(
            R.randint(stack.at(t), (30,), 0, 7).numpy(),
            R.randint(keys[t], (30,), 0, 7).numpy())


def test_normal_close():
    """The uniform under √2·erf_inv is bitwise; erf_inv is XLA's polynomial
    with torch's log1p: 99.07% of 10^5 draws bitwise, the rest within 3
    ulps. (torch's own CPU erfinv, used before, was 5.6e-6 relative off
    and, in some processes, 6.6e-5 on one worker thread's share.)"""
    want = np.asarray(jax.random.normal(jax.random.key(4), (100_000,)))
    got = R.normal(R.key(4), (100_000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_erf_inv_is_xlas_polynomial():
    """R.erf_inv against lax.erf_inv on a grid over (−1, 1) and the last
    5000 f32 values below 1 (the w ≥ 5 branch): bitwise for ≥ 98% of them,
    within 2 ulps everywhere, ±1 to ±inf."""
    x = np.concatenate([
        np.linspace(-1, 1, 200_001, dtype=np.float32)[1:-1],
        np.float32(1) - np.arange(1, 5001, dtype=np.float32)
        * np.float32(2 ** -24)])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = R.erf_inv(torch.from_numpy(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2 and (ulps == 0).mean() >= 0.98
    edge = R.erf_inv(torch.tensor([-1.0, 1.0])).numpy()
    np.testing.assert_array_equal(edge, [-np.inf, np.inf])


def test_normal_does_not_depend_on_threads():
    """The same draw under 1, 2 and the default number of CPU threads."""
    want = R.normal(R.key(4), (100_000,))
    n = torch.get_num_threads()
    try:
        for t in (1, 2):
            torch.set_num_threads(t)
            assert torch.equal(R.normal(R.key(4), (100_000,)), want)
    finally:
        torch.set_num_threads(n)
