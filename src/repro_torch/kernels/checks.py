"""Kernel-vs-plain checks of the serving kernels, and the sweep grids.

`chip_smoke.py` and `tests/test_torch_cuda.py` hold the CUDA kernels
against their plain versions with these same inputs and grids. On a CPU
device both sides run the plain version, so the checks pass trivially
there; they mean something on a CUDA device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

BITS = (1, 2, 4, 8)
# N of the codec kernels and the FWHT: 128 is the serving path's dh
CODEC_N = (32, 128, 256, 8192)
PACK_N = (32, 128, 256, 8192, 12288)
ATTN_DH = (64, 128)
ATTN_C = (1, 100, 512, 1000)
ATTN_G = (1, 8)
ATTN_TOL = 2e-4          # the JAX package's bound for its Pallas kernel


def pack_inputs(rows, n, seed, dev):
    """x (rows, n) and scales above and below the rows' maxima (so the clip
    acts), with row 3 at scale 0 (the FLT_MIN guard)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(rows, n, generator=g, device=dev)
    scale = x.abs().amax(-1, keepdim=True) * (
        0.5 + torch.rand(rows, 1, generator=g, device=dev))
    scale[3] = 0.0
    return x, scale


def check_quantize_pack(n, bits, dev) -> None:
    """Bitwise over 37 rows (they do not fill a block), flat and with lead
    dims given as expanded views."""
    rows = 37
    x, scale = pack_inputs(rows, n, n * 10 + bits, dev)
    if not torch.equal(ops.quantize_pack(x, scale, bits),
                       ref.quantize_pack(x, scale, bits)):
        raise AssertionError(f"quantize_pack differs: bits={bits} n={n}")
    x3 = x.reshape(rows, 1, n).expand(rows, 2, n)
    s3 = scale.reshape(rows, 1, 1).expand(rows, 2, 1)
    if not torch.equal(ops.quantize_pack(x3, s3, bits),
                       ref.quantize_pack(x3, s3, bits)):
        raise AssertionError(f"quantize_pack differs on views: bits={bits} "
                             f"n={n}")


def attention_inputs(b, c, kh, g, dh, bits, seed, dev, lens=None):
    """Pre-scaled queries, K/V words drawn over the whole int32 range
    (negative ones included), scales in [0.1, 1.1), and kv_len cycling
    through 0, 1, C and a ragged length unless `lens` is given."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    wpv = dh * bits // 32
    q = torch.randn(b, kh, g, dh, generator=gen, device=dev) * dh ** -0.5

    def words():
        return torch.randint(-2 ** 31, 2 ** 31, (b, c, kh, wpv),
                             generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def scales():
        return torch.rand(b, c, kh, generator=gen, device=dev) + 0.1

    kw, ks, vw, vs = words(), scales(), words(), scales()
    if lens is None:
        lens = [(0, 1, c, max(1, (2 * c) // 3))[i % 4] for i in range(b)]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kw, ks, vw, vs, kv_len


def check_quant_decode_attention(bits, dh, c, g, dev) -> float:
    """Within ATTN_TOL at B 4 (kv_len 0, 1, C, ragged) and 2 KV heads, with
    and without the inverse rotation of V; returns the max abs error."""
    args = attention_inputs(4, c, 2, g, dh, bits, c + dh + bits + g, dev)
    err = 0.0
    for inv in (True, False):
        got = ops.quant_decode_attention(*args, bits=bits, inv_rotate_v=inv)
        want = ref.quant_decode_attention(*args, bits=bits, inv_rotate_v=inv)
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=ATTN_TOL, atol=ATTN_TOL):
            raise AssertionError(
                f"quant_decode_attention differs: bits={bits} dh={dh} C={c} "
                f"G={g} inv_rotate_v={inv}: max abs err {e}")
        err = max(err, e)
    return err
