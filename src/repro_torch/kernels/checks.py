"""Kernel-vs-plain checks of the codec and serving kernels, and the sweep
grids (the codec grid below and above N = 8192, where the FWHT and the
encoders run their row kernels up to 2^15 and passes beyond).

`chip_smoke.py` and `tests/test_torch_cuda.py` hold the CUDA kernels
against their plain versions with these same inputs and grids. On a CPU
device both sides run the plain version, so the checks pass trivially
there; they mean something on a CUDA device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, ref

BITS = (1, 2, 4, 8)
# N of the codec kernels and the FWHT: every power of two from 32 to 8192,
# so every V of the warp-resident kernels, every word that spans lanes
# (V < 32/bits) and both sides of the register cap; 128 is the serving
# path's dh, 256 the training chunk
CODEC_N = tuple(2 ** i for i in range(5, 14))
# the FWHT alone below 32 (the serve path's small heads, N < 4 in shared
# memory)
FWHT_SMALL_N = (1, 2, 4, 8, 16)
# rows that leave a warp item or a block partly filled
CODEC_ROWS = (1, 37, 1031)
CODEC_MODES = ("det", "dither", "mask", "rescale")
# N above 8192: the FWHT's and the encoders' row kernels at 2^14 and 2^15;
# from 2^16 the FWHT's passes (2^16, 2^17: a last pass of one and two
# stages; 2^20: 15 + 5), the encoders' cluster kernel at 2^16 and 2^17 and
# their passes, every fold of them, at 2^20, at rows LARGE_ROWS
LARGE_N = (16384, 32768, 2 ** 16, 2 ** 17, 2 ** 20)
LARGE_ROWS = (1, 37)
# the row kernels (the FWHT's, and the encoders' alone) at more rows than
# the card has SMs (132 on an H100), so that each persistent block strides
# over rows and its staged copy of the next row is used
ROW_N = (16384, 32768)
ROW_ROWS = (300,)
# the encoders' cluster kernel (a cluster of 4 or 8 CTAs a row), at rows
# LARGE_ROWS + ROW_ROWS: more rows than clusters fit, so that each
# persistent cluster strides over rows
CLUSTER_N = (2 ** 16, 2 ** 17)
# the FWHT alone on one row of the dsc codec's largest frames (yi-6b's
# leaves): 2^23 (two passes: 15 + 8), 2^26 and 2^28 (three)
FWHT_HUGE_N = (2 ** 23, 2 ** 26, 2 ** 28)
PACK_N = (32, 128, 256, 8192, 12288)
# quantize_pack rows: one, a block partly filled, several blocks
PACK_ROWS = (1, 37, 1031)
# unpack_dequant beyond the encoder's payloads: (n, N), n values kept of
# rows of N = wpr·32/bits codes. Whole rows at a power-of-two wpr (the
# flat path); whole rows at wpr = 3·2^j (96, 12288) and trimmed rows by
# one value, by half and to one value (the row path)
UNPACK_SHAPES = ((32, 32), (256, 256), (8192, 8192), (96, 96),
                 (12288, 12288), (255, 256), (128, 256), (1, 32))
ATTN_DH = (32, 64, 128, 256)   # every dh of the warp-resident kernel
# C of one tile, of a ragged last split, of several whole splits, and
# 4096 / 4097 (a last split of one position) at 8 (b, kv-head) pairs
ATTN_C = (1, 100, 512, 1000, 4096, 4097)
ATTN_G = (1, 8)
# (dh, G) of the served families beside yi-6b's (128, 8): hymba-1.5b's
# 25/5 heads at dh 64 and mixtral-8x22b's 48/8 at dh 128, swept over
# ATTN_C
ATTN_FAMILY_SHAPES = ((64, 5), (128, 6))
# (dh, G) outside the warp-resident kernel's G <= 8, 32 <= dh <= 256, which
# run the shared-memory tile kernel, at C of one tile and of several splits
ATTN_TILE_SHAPES = ((16, 8), (128, 12), (512, 2))
ATTN_TILE_C = (1, 100, 1000)
ATTN_TOL = 2e-4          # the JAX package's bound for its Pallas kernel


def codec_inputs(rows, n, bits, seed, dev):
    """x (rows, n), ±1 signs, a dither in [-Δ/2, Δ/2) and a 0/1 row mask.
    With rows > 6, row 3 is all zero (the FLT_MIN guard), row 5 is zero but
    for its last value, and row 6 embeds to a spike at its last value (the
    row maximum in the last lane)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(rows, n, generator=g, device=dev)
    signs = torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                        1.0, -1.0)
    delta = 2.0 / 2 ** bits
    dither = (torch.rand(rows, n, generator=g, device=dev) - 0.5) * delta
    mask = (torch.rand(rows, 1, generator=g, device=dev) < 0.6).float()
    if rows > 6:
        x[3] = 0.0
        x[5] = 0.0
        x[5, -1] = 1.5
        spike = torch.zeros(n, device=dev)
        spike[-1] = 3.0
        x[6] = ref.fwht(spike) * signs + 0.01 * x[6]
    return x, signs, dither, mask


def unaligned_copy(x):
    """A contiguous copy of x whose data sit 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def check_fwht(n, rows, dev) -> None:
    """The FWHT bitwise, from aligned and unaligned data."""
    x = torch.randn(rows, n, generator=torch.Generator(device=dev)
                    .manual_seed(n + rows), device=dev)
    want = ref.fwht(x)
    if not (torch.equal(ops.fwht(x), want)
            and torch.equal(ops.fwht(unaligned_copy(x)), want)):
        raise AssertionError(f"fwht differs: n={n} rows={rows}")


def check_codec(n, bits, mode, rows, dev) -> None:
    """encode, encode_ef (f32 and bf16 residuals), unpack_dequant and the
    FWHT bitwise with their plain versions; mode is one of CODEC_MODES
    ("rescale": dither, mask and rescale 0.6, the dithered unbiased path).
    In "det" mode also from unaligned inputs."""
    x, rw, rs = check_encoders(n, bits, mode, rows, dev)
    what = f"bits={bits} n={n} {mode} rows={rows}"
    if not torch.equal(ops.unpack_dequant(rw, rs, bits, n),
                       ref.unpack_dequant(rw, rs, bits, n)):
        raise AssertionError(f"unpack_dequant differs: {what}")
    if not torch.equal(ops.fwht(x), ref.fwht(x)):
        raise AssertionError(f"fwht differs: {what}")


def check_encoders(n, bits, mode, rows, dev, unaligned=False) -> tuple:
    """check_codec's encoders alone: encode and encode_ef (f32 and bf16
    residuals) bitwise, in "det" mode (in every mode where `unaligned`)
    also from unaligned inputs. Returns (x, words, scale) of the plain
    encode."""
    x, signs, dither, mask = codec_inputs(rows, n, bits, n + bits + rows,
                                          dev)
    d = dither if mode in ("dither", "rescale") else None
    m = mask if mode in ("mask", "rescale") else None
    rescale = 0.6 if mode == "rescale" else None
    what = f"bits={bits} n={n} {mode} rows={rows}"
    rw, rs = ref.encode(x, signs, bits, dither=d, mask=m)
    resid = {rdt: ref.encode_ef(x, signs, bits, dither=d, mask=m,
                                rescale=rescale, residual_dtype=rdt)[2]
             for rdt in (torch.float32, torch.bfloat16)}

    def same(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    for xi in [x] + ([unaligned_copy(x)] if unaligned or mode == "det"
                     else []):
        kw, ks = ops.encode(xi, signs, bits, dither=d, mask=m)
        if not (torch.equal(kw, rw) and same(ks, rs)):
            raise AssertionError(f"encode payload differs: {what}")
        for rdt, rr in resid.items():
            kw2, ks2, kr = ops.encode_ef(xi, signs, bits, dither=d, mask=m,
                                         rescale=rescale, residual_dtype=rdt)
            if not (torch.equal(kw2, rw) and same(ks2, rs) and same(kr, rr)):
                raise AssertionError(f"encode_ef differs: {what} {rdt}")
    return x, rw, rs


def check_unpack(bits, n, full_n, rows, dev) -> None:
    """unpack_dequant bitwise with its plain version on words drawn over
    the whole int32 range (every code of every lane), from aligned and
    unaligned words; row 3 has scale 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(n + full_n + bits + rows)
    wpr = full_n * bits // 32
    words = torch.randint(-2 ** 31, 2 ** 31, (rows, wpr), generator=g,
                          device=dev, dtype=torch.int64).to(torch.int32)
    scale = torch.rand(rows, 1, generator=g, device=dev) + 0.1
    if rows > 3:
        scale[3] = 0.0
    want = ref.unpack_dequant(words, scale, bits, n)
    got = [ops.unpack_dequant(words, scale, bits, n),
           ops.unpack_dequant(unaligned_copy(words), scale, bits, n)]
    for i, out in enumerate(got):
        if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"unpack_dequant differs: bits={bits} n={n} "
                                 f"N={full_n} rows={rows} case {i}")


def pack_inputs(rows, n, seed, dev):
    """x (rows, n) and scales above and below the rows' maxima (so the clip
    acts); the last row's maximum sits in its last lane, at the scale (the
    top code in the word's top bit field); with rows > 3 row 3 has scale 0
    (the FLT_MIN guard)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(rows, n, generator=g, device=dev)
    scale = x.abs().amax(-1, keepdim=True) * (
        0.5 + torch.rand(rows, 1, generator=g, device=dev))
    x[-1, -1] = 8.0
    scale[-1] = 8.0
    if rows > 3:
        scale[3] = 0.0
    return x, scale


def check_quantize_pack(n, bits, dev, rows_grid=PACK_ROWS) -> None:
    """Bitwise over each of `rows_grid` rows (one, a block partly filled,
    several blocks), flat and with lead dims given as expanded views, and
    from an unaligned x."""
    for rows in rows_grid:
        x, scale = pack_inputs(rows, n, n * 10 + bits + rows, dev)
        want = ref.quantize_pack(x, scale, bits)
        for xi in (x, unaligned_copy(x)):
            if not torch.equal(ops.quantize_pack(xi, scale, bits), want):
                raise AssertionError(f"quantize_pack differs: bits={bits} "
                                     f"n={n} rows={rows}")
        x3 = x.reshape(rows, 1, n).expand(rows, 2, n)
        s3 = scale.reshape(rows, 1, 1).expand(rows, 2, 1)
        if not torch.equal(ops.quantize_pack(x3, s3, bits),
                           ref.quantize_pack(x3, s3, bits)):
            raise AssertionError(f"quantize_pack differs on views: "
                                 f"bits={bits} n={n} rows={rows}")


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


def ratq_rung_sweep(ladder: int = 16, draws: int = 100_000,
                    seed: int = 0) -> torch.Tensor:
    """RATQ's relative ranges where its rung is decided: every f32 within
    64 ulps of each power of two from 2^(1−h) to 1, then `draws` uniform
    values in [0, 1) (CPU, f32). The rung is ⌈log2⌉ of these, so one ulp of
    a device's log flips it at exactly these points."""
    offsets = torch.arange(-64, 65, dtype=torch.int32)
    near = [(torch.tensor(2.0 ** e, dtype=torch.float32).view(torch.int32)
             + offsets).view(torch.float32) for e in range(1 - ladder, 1)]
    g = torch.Generator().manual_seed(seed)
    return torch.cat(near + [torch.rand(draws, generator=g)])
