"""repro_torch kernels: the plain versions and CPU dispatch vs the JAX
reference.

Inputs are made with numpy from a seed and handed to both packages. Every
payload check is bitwise (words and the bits of the f32 scales). Float
outputs are held to the bounds the JAX package's own tests use
(`tests/test_kernels.py`): EF residual ≤ 4e-6 abs in f32 and ≤ 4e-3 in
bf16. On the CPU the port repeats the eager reference op for op, so those
come out bitwise too; the bounds are what the contract promises.
The CUDA kernels themselves are tested on the card by test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fwht as fwht_kernel
from repro.kernels import quantencode as qe_kernel
from repro.kernels import quantpack as qp_kernel
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fwht import fwht_cuda
from repro_torch.kernels.optim import (adamw_update_cuda, sgd_update_cuda,
                                       sum_squares_cuda)
from repro_torch.kernels.quantdecode import quant_decode_attention_cuda
from repro_torch.kernels.quantencode import encode_cuda, encode_ef_cuda
from repro_torch.kernels.quantpack import (quantize_pack_cuda,
                                           unpack_dequant_cuda)

MODES = ["det", "dither", "mask", "dither_mask"]


def _bits(a):
    return np.asarray(a).view(np.int32)


def _inputs(rows, n, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    signs = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    delta = 2.0 / 2 ** bits
    dither = ((rng.random((rows, n)) - 0.5) * delta).astype(np.float32)
    mask = (rng.random((rows, 1)) < 0.6).astype(np.float32)
    return x, signs, dither, mask


def _mode(mode, dither, mask):
    return (dither if "dither" in mode else None,
            mask if "mask" in mode else None)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# plain versions on the CPU vs eager repro.kernels.ref
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [2, 64, 1024])
@pytest.mark.parametrize("lead", [(), (3, 4)])
def test_fwht_bitwise_vs_jax_ref(n, lead):
    x = np.random.default_rng(n).standard_normal(lead + (n,)).astype(
        np.float32)
    want = jref.fwht(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(want), _bits(ops.fwht(_t(x))))


def test_fwht_rejects_non_pow2():
    with pytest.raises(ValueError):
        ref.fwht(torch.zeros(2, 48))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,n", [(1, 32), (7, 128), (16, 1024)])
def test_quantpack_unpack_bitwise_vs_jax_ref(bits, rows, n):
    x = np.random.default_rng(rows).standard_normal((rows, n)).astype(
        np.float32)
    scale = np.abs(x).max(-1, keepdims=True)
    want = jref.quantize_pack(jnp.asarray(x), jnp.asarray(scale), bits)
    got = ops.quantize_pack(_t(x), _t(scale), bits)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    back_j = jref.unpack_dequant(want, jnp.asarray(scale), bits, n)
    back_t = ops.unpack_dequant(got, _t(scale), bits, n)
    np.testing.assert_array_equal(_bits(back_j), _bits(back_t))


def test_unpack_dequant_trims_to_n():
    words = torch.tensor([[0x76543210, -1]], dtype=torch.int32)
    out = ref.unpack_dequant(words, torch.ones(1, 1), 4, 11)
    assert out.shape == (1, 11)
    want = jref.unpack_dequant(jnp.asarray(words.numpy()), jnp.ones((1, 1)),
                               4, 11)
    np.testing.assert_array_equal(np.asarray(want), out.numpy())


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,n", [(1, 32), (8, 128), (13, 256)])
@pytest.mark.parametrize("mode", MODES)
def test_encode_payload_bitwise_vs_jax_ref(bits, rows, n, mode):
    x, signs, dither, mask = _inputs(rows, n, bits, bits * 100 + rows)
    d, m = _mode(mode, dither, mask)
    jw, js = jref.encode(jnp.asarray(x), jnp.asarray(signs), bits,
                         dither=_j(d), mask=_j(m))
    tw, ts = ops.encode(_t(x), _t(signs), bits, dither=_t(d), mask=_t(m))
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(_bits(js), _bits(ts))


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("rows,n", [(5, 128), (13, 64)])
@pytest.mark.parametrize("mode", ["det", "dither_mask", "rescale"])
@pytest.mark.parametrize("rdt", ["float32", "bfloat16"])
def test_encode_ef_vs_jax_ref(bits, rows, n, mode, rdt):
    x, signs, dither, mask = _inputs(rows, n, bits, bits * 10 + rows)
    d, m = (None, None) if mode == "det" else (dither, mask)
    rescale = 0.6 if mode == "rescale" else None
    jw, js, jr = jref.encode_ef(jnp.asarray(x), jnp.asarray(signs), bits,
                                dither=_j(d), mask=_j(m), rescale=rescale,
                                residual_dtype=getattr(jnp, rdt))
    tw, ts, tr = ops.encode_ef(_t(x), _t(signs), bits, dither=_t(d),
                               mask=_t(m), rescale=rescale,
                               residual_dtype=getattr(torch, rdt))
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(_bits(js), _bits(ts))
    tol = 4e-6 if rdt == "float32" else 4e-3
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=tol, rtol=0)


def test_quant_decode_attention_plain_vs_jax_ref():
    """Not on this slice's path; its plain version is ported for the later
    kernel. rtol = atol = 2e-4, the JAX package's own bound
    (tests/test_kvquant.py): softmax and two einsums sum in another order."""
    rng = np.random.default_rng(9)
    b, kh, g, dh, c, bits = 2, 2, 3, 64, 10, 4
    q = rng.standard_normal((b, kh, g, dh)).astype(np.float32) * 0.1
    words = [rng.integers(-2 ** 31, 2 ** 31, (b, c, kh, dh * bits // 32),
                          dtype=np.int64).astype(np.int32) for _ in range(2)]
    scales = [rng.random((b, c, kh)).astype(np.float32) + 0.5
              for _ in range(2)]
    kv_len = np.array([7, 10], np.int32)
    args = (q, words[0], scales[0], words[1], scales[1], kv_len)
    want = jref.quant_decode_attention(*map(jnp.asarray, args), bits=bits)
    got = ref.quant_decode_attention(*map(torch.from_numpy, args), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# ... and vs the Pallas kernels in interpret mode, on a few small shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,rows,n,mode", [(1, 3, 32, "dither_mask"),
                                              (4, 8, 128, "det"),
                                              (8, 5, 64, "mask")])
def test_plain_versions_match_pallas_interpret(bits, rows, n, mode):
    x, signs, dither, mask = _inputs(rows, n, bits, rows)
    d, m = _mode(mode, dither, mask)
    kw, ks, kr = qe_kernel.encode_ef_pallas(
        jnp.asarray(x), jnp.asarray(signs), bits, dither=_j(d), mask=_j(m),
        interpret=True)
    tw, ts, tr = ops.encode_ef(_t(x), _t(signs), bits, dither=_t(d),
                               mask=_t(m))
    np.testing.assert_array_equal(np.asarray(kw), tw.numpy())
    np.testing.assert_array_equal(_bits(ks), _bits(ts))
    # the Pallas EF decode may be fma-contracted by XLA: the JAX tests' bound
    np.testing.assert_allclose(tr.numpy(), np.asarray(kr), atol=4e-6, rtol=0)
    back = qp_kernel.unpack_dequant_pallas(kw, ks, bits, n, interpret=True)
    np.testing.assert_array_equal(
        _bits(back), _bits(ops.unpack_dequant(tw, ts, bits, n)))
    np.testing.assert_allclose(
        ops.fwht(_t(x)).numpy(),
        np.asarray(fwht_kernel.fwht_pallas(jnp.asarray(x), interpret=True)),
        rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch and wrapper contracts that hold without a card
# ---------------------------------------------------------------------------
def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: a tensor that is not on the card is
    refused, whatever it holds (no launch counted)."""
    ops.reset_launch_counts()
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fwht_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        encode_cuda(x, torch.ones(64), 4)
    with pytest.raises(ValueError, match="CUDA"):
        encode_ef_cuda(x, torch.ones(64), 4)
    with pytest.raises(ValueError, match="CUDA"):
        unpack_dequant_cuda(torch.zeros(4, 8, dtype=torch.int32),
                            torch.ones(4, 1), 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_pack_cuda(x, torch.ones(4, 1), 4)
    words = torch.zeros(1, 3, 2, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        quant_decode_attention_cuda(
            torch.zeros(1, 2, 4, 64), words, torch.ones(1, 3, 2), words,
            torch.ones(1, 3, 2), torch.ones(1, dtype=torch.int32), bits=8)
    one = torch.ones(())
    with pytest.raises(ValueError, match="CUDA"):
        sum_squares_cuda([x])
    with pytest.raises(ValueError, match="CUDA"):
        adamw_update_cuda(x, x, x, x, one, one, one, b1=0.9, b2=0.95,
                          eps=1e-8, weight_decay=0.0)
    with pytest.raises(ValueError, match="CUDA"):
        sgd_update_cuda(x, None, x, one, momentum=0.0, nesterov=False)
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
    assert len(ops.KERNELS) == 9


def test_cpu_dispatch_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(3, 64)
    ops.encode_ef(x, torch.ones(64), 4)
    ops.unrotate(ops.fwht(x), torch.ones(64))
    assert sum(ops.launch_counts().values()) == 0
