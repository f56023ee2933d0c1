"""The index math of the CUDA unpack_dequant (`csrc/quantpack.cu`), on the
CPU.

Whole rows (n == wpr·32/bits) at a power-of-two wpr take the flat
kernel: the output is one stream, thread f of the grid stores float4 f,
made of codes 4·(f mod F4) .. +3 of word f / F4 (F4 = 8/bits float4s a
word) at shift j·bits, with the scale of row (word index >> log2 wpr).
Other rows (trimmed, or a wpr not a power of two) take the row kernel, one
float per thread. Here a torch model of both mappings, written in this file, is held
bitwise against the port's plain version, the JAX reference and the Pallas
kernel in interpret mode, on words drawn over the whole int32 range."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantpack as jqp
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quantpack import unpack_path


def dequant(idx, bits, s):
    """ndsc::dequant, one f32 rounding per step: (−1 + (2·idx + 1)·2^−bits)
    · s."""
    t = 2.0 * idx.to(torch.float32) + 1.0
    return (-1.0 + t * (1.0 / 2 ** bits)) * s


def flat_model(words, scale, bits):
    """The flat kernel: float4 f of a (rows, wpr·32/bits) stream."""
    rows, wpr = words.shape
    f4 = 8 // bits
    f = torch.arange(rows * wpr * f4, dtype=torch.int64)
    wi = f >> (f4.bit_length() - 1)
    w = (words.reshape(-1).to(torch.int64) & 0xFFFFFFFF)[wi]
    assert wpr & (wpr - 1) == 0
    row = wi >> (wpr.bit_length() - 1)
    s = scale.reshape(-1)[row][:, None]
    sh = ((f & (f4 - 1)) * 4 * bits)[:, None] + torch.arange(4) * bits
    vals = dequant((w[:, None] >> sh) & (2 ** bits - 1), bits, s)
    return vals.reshape(rows, wpr * 32 // bits)


def rows_model(words, scale, bits, n):
    """The row kernel: float e = (r, j) of (rows, n), code j mod k of word
    j / k of row r."""
    rows, wpr = words.shape
    k = 32 // bits
    e = torch.arange(rows * n, dtype=torch.int64)
    r, j = e // n, e % n
    w = (words.reshape(-1).to(torch.int64) & 0xFFFFFFFF)[r * wpr + j // k]
    idx = (w >> ((j % k) * bits)) & (2 ** bits - 1)
    return dequant(idx, bits, scale.reshape(-1)[r]).reshape(rows, n)


def model(words, scale, bits, n):
    if unpack_path(n, words.shape[1], bits) == "flat":
        return flat_model(words, scale, bits)
    return rows_model(words, scale, bits, n)


def _inputs(rows, wpr, seed):
    """Words over the whole int32 range, scales in [0.1, 1.1), row 3 at
    scale 0."""
    rng = np.random.default_rng(seed)
    words = rng.integers(-2 ** 31, 2 ** 31, (rows, wpr),
                         dtype=np.int64).astype(np.int32)
    scale = (rng.uniform(size=(rows, 1)) + 0.1).astype(np.float32)
    if rows > 3:
        scale[3] = 0.0
    return words, scale


def _bits(a):
    return np.asarray(a).view(np.int32)


def _check(bits, n, full_n, rows):
    words, scale = _inputs(rows, full_n * bits // 32, n + full_n + rows + bits)
    got = _bits(model(torch.from_numpy(words), torch.from_numpy(scale), bits,
                      n))
    plain = ops.unpack_dequant(torch.from_numpy(words),
                               torch.from_numpy(scale), bits, n)
    np.testing.assert_array_equal(got, _bits(plain))
    np.testing.assert_array_equal(got, _bits(jref.unpack_dequant(
        jnp.asarray(words), jnp.asarray(scale), bits, n)))
    if n % (32 // bits) == 0:          # the Pallas kernel's contract
        np.testing.assert_array_equal(got, _bits(jqp.unpack_dequant_pallas(
            jnp.asarray(words), jnp.asarray(scale), bits, n,
            interpret=True)))


@pytest.mark.parametrize("rows", [1, 37, 1031])
@pytest.mark.parametrize("n", [32, 256, 8192])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_flat_mapping_vs_plain_jax_and_pallas(bits, n, rows):
    """Whole rows at a power-of-two wpr: the flat kernel's mapping."""
    assert unpack_path(n, n * bits // 32, bits) == "flat"
    _check(bits, n, n, rows)


# (n, N): n values kept of rows of N codes, all on the row kernel: whole
# rows at a wpr of 3·2^j (96, 12288), and trimmed rows cut by one value
# (not a multiple of k), by half and to one value
@pytest.mark.parametrize("n,full_n", [(96, 96), (12288, 12288), (255, 256),
                                      (128, 256), (1, 32)])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_odd_wpr_and_trimmed_rows_vs_plain_jax_and_pallas(bits, n, full_n):
    _check(bits, n, full_n, 37)


def test_path_choice():
    """Flat exactly where rows are whole and wpr is a power of two; every
    other row takes the row kernel."""
    for bits in (1, 2, 4, 8):
        k = 32 // bits
        for wpr in (1, 3, 8, 24, 32, 2048):
            whole = "flat" if wpr & (wpr - 1) == 0 else "rows"
            assert unpack_path(wpr * k, wpr, bits) == whole
            for n in {1, k - 1, wpr * k - 1, (wpr * k) // 2} - {0}:
                assert unpack_path(n, wpr, bits) == "rows"


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("wpr", [1, 2, 32])
def test_flat_mapping_writes_each_code_once(bits, wpr):
    """Float4 f covers floats [4f, 4f + 4) = codes of word f / F4 at
    shifts 4·(f mod F4)·bits + {0, 1, 2, 3}·bits: every (word, code) once,
    and word w's codes land at floats [w·k, w·k + k) in code order."""
    rows, f4, k = 5, 8 // bits, 32 // bits
    f = torch.arange(rows * wpr * f4)
    wi = f >> (f4.bit_length() - 1)
    code = ((f & (f4 - 1)) * 4)[:, None] + torch.arange(4)
    flat_pos = (4 * f)[:, None] + torch.arange(4)
    assert torch.equal(flat_pos, wi[:, None] * k + code)
    assert torch.equal(flat_pos.flatten(), torch.arange(rows * wpr * k))
    assert int(code.max()) * bits + bits <= 32
