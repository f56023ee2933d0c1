"""The split-then-combine arithmetic of the CUDA decode attention
(`csrc/quantdecode.cu`), on the CPU.

The card splits each (batch, kv-head) cache across blocks: split i walks
positions [i·L, min((i+1)·L, C)) up to min(kv_len, C) (all C when
kv_len = 0), writes its running max m, sum l and unnormalized accumulator,
and a combining pass weighs split i by exp(m_i − max m). `num_splits` and
`split_len` choose S and L on the host. Here a torch model of that
arithmetic, written in this file, is held against the Pallas kernel in
interpret mode (block_c = L), the JAX reference and the port's plain
version, within rtol = atol = 2e-4, the bound the JAX package holds its
Pallas kernel to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quantdecode as jqd
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quantdecode import (BLOCKS_PER_SM, WARP_TILE,
                                             num_splits, split_len, tile_len,
                                             warp_path)

TOL = 2e-4
NEG = -1e30


@pytest.mark.parametrize("pairs", [1, 2, 8, 16, 128, 1024])
def test_num_splits_invariants(pairs):
    """1 ≤ S ≤ tiles, every split whole tiles and none empty, the splits
    cover [0, C) exactly once, S = 1 within one tile, and S·pairs near
    BLOCKS_PER_SM (at least two) blocks per SM where the tiles allow."""
    assert BLOCKS_PER_SM >= 2
    for tc in (16, 64):
        for c in (1, 15, 16, 17, 63, 64, 65, 100, 512, 1000, 4096, 4097,
                  32768):
            tiles = -(-c // tc)
            for sms in (1, 16, 78, 132, 144):
                s = num_splits(pairs // 2 or 1, 2 if pairs > 1 else 1, c, tc,
                               sms)
                length = split_len(c, tc, s)
                assert 1 <= s <= tiles
                assert length % tc == 0 and length >= tc
                starts = [i * length for i in range(s)]
                ends = [min(x + length, c) for x in starts]
                assert all(a < e for a, e in zip(starts, ends))  # none empty
                assert starts[0] == 0 and ends[-1] == c
                assert all(e == a for e, a in zip(ends, starts[1:]))
                if c <= tc:
                    assert s == 1
                want = min(tiles, -(-BLOCKS_PER_SM * sms // pairs))
                assert s <= want and 2 * s >= want


def test_num_splits_at_the_serve_and_long_shapes():
    """yi-6b (G 8, dh 128) runs the warp-resident kernel, tiles of 64. B 4
    × K 4 at C 512 on 132 SMs: 8 splits of one tile; B 32 × K 4 at
    C 32768: 9 splits of 57 tiles."""
    assert warp_path(8, 128) and not warp_path(12, 128)
    assert not warp_path(8, 16) and not warp_path(8, 512)
    assert num_splits(4, 4, 512, WARP_TILE, 132) == 8
    assert split_len(512, WARP_TILE, 8) == 64
    assert num_splits(32, 4, 32768, WARP_TILE, 132) == 9
    assert split_len(32768, WARP_TILE, 9) == 57 * 64


def split_combine(q, kw, ks, vw, vs, kv_len, *, bits, length,
                  inv_rotate_v):
    """The card's arithmetic in torch: partial (m, l, acc) per split of
    `length` positions, then the combine."""
    c, dh = kw.shape[1], q.shape[-1]
    kd = tref.unpack_dequant(kw, ks[..., None], bits, dh)
    vd = tref.unpack_dequant(vw, vs[..., None], bits, dh)
    s = torch.einsum("bkgd,bckd->bkgc", q, kd)
    pos = torch.arange(c)
    s = torch.where((pos < kv_len[:, None])[:, None, None, :], s,
                    torch.full_like(s, NEG))
    n_pos = torch.where(kv_len >= 1, kv_len.clamp(max=c), c)
    visited = (pos < n_pos[:, None])[:, None, None, :]          # (B,1,1,C)
    ms, ls, accs = [], [], []
    for p0 in range(0, c, length):
        sl = slice(p0, min(p0 + length, c))
        vis, sc = visited[..., sl], s[..., sl]
        m = torch.where(vis, sc, torch.full_like(sc, NEG)).amax(-1)
        p = torch.where(vis, torch.exp(sc - m[..., None]),
                        torch.zeros_like(sc))
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgc,bckd->bkgd", p, vd[:, sl]))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(0))                                 # (S,B,K,G)
    out = (w[..., None] * acc).sum(0) / (w * l).sum(0).clamp(
        min=1e-30)[..., None]
    return tref.fwht(out) if inv_rotate_v else out


def _inputs(b, c, kh, g, dh, bits, lens, seed):
    """Pre-scaled queries, packed words over the whole int32 range, scales
    in [0.1, 1.1), as numpy arrays."""
    rng = np.random.default_rng(seed)
    wpv = dh * bits // 32
    q = (rng.standard_normal((b, kh, g, dh)) * dh ** -0.5).astype(np.float32)
    kw = rng.integers(-2 ** 31, 2 ** 31, (b, c, kh, wpv),
                      dtype=np.int64).astype(np.int32)
    vw = rng.integers(-2 ** 31, 2 ** 31, (b, c, kh, wpv),
                      dtype=np.int64).astype(np.int32)
    ks = (rng.uniform(size=(b, c, kh)) + 0.1).astype(np.float32)
    vs = (rng.uniform(size=(b, c, kh)) + 0.1).astype(np.float32)
    return q, kw, ks, vw, vs, np.asarray(lens, np.int32)


# kv_len per batch row: 0 (uniform mean over all C), 1 (every later split
# wholly past it), a ragged length inside a split, C
@pytest.mark.parametrize("inv_rotate_v", [True, False])
@pytest.mark.parametrize("bits", [1, 8])
@pytest.mark.parametrize("length", [16, 32])
def test_split_combine_vs_pallas_ref_and_plain(length, bits, inv_rotate_v):
    b, c, kh, g, dh = 4, 64, 2, 4, 64
    args = _inputs(b, c, kh, g, dh, bits, [0, 1, 37, c], 100 + length + bits)
    got = split_combine(*map(torch.from_numpy, args), bits=bits,
                        length=length, inv_rotate_v=inv_rotate_v).numpy()
    jargs = tuple(map(jnp.asarray, args))
    pallas = np.asarray(jqd.quant_decode_attention_pallas(
        *jargs, bits=bits, block_c=length, inv_rotate_v=inv_rotate_v,
        interpret=True))
    want = np.asarray(jref.quant_decode_attention(
        *jargs, bits=bits, inv_rotate_v=inv_rotate_v))
    plain = ops.quant_decode_attention(
        *map(torch.from_numpy, args), bits=bits,
        inv_rotate_v=inv_rotate_v).numpy()
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("inv_rotate_v", [True, False])
@pytest.mark.parametrize("c", [100, 4097])
def test_split_combine_ragged_last_split_vs_ref_and_plain(c, inv_rotate_v):
    """The wrapper's own plan (8 (b, kv-head) pairs on 132 SMs, the
    warp-resident kernel's tiles of 64): C 100 gives a last split of 36
    positions, C 4097 one of a single position; kv_len 0, 1, ragged and
    C."""
    b, kh, g, dh, bits = 4, 2, 8, 64, 8
    tc = WARP_TILE if warp_path(g, dh) else tile_len(dh)
    s = num_splits(b, kh, c, tc, 132)
    length = split_len(c, tc, s)
    assert s > 1 and c % length
    args = _inputs(b, c, kh, g, dh, bits, [0, 1, (2 * c) // 3, c], c)
    got = split_combine(*map(torch.from_numpy, args), bits=bits,
                        length=length, inv_rotate_v=inv_rotate_v).numpy()
    want = np.asarray(jref.quant_decode_attention(
        *map(jnp.asarray, args), bits=bits, inv_rotate_v=inv_rotate_v))
    plain = ops.quant_decode_attention(
        *map(torch.from_numpy, args), bits=bits,
        inv_rotate_v=inv_rotate_v).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, plain, rtol=TOL, atol=TOL)


def test_empty_split_weighs_exactly_zero():
    """A split wholly past kv_len writes m = -1e30, l = 0, acc = 0: in f32
    its weight exp(-1e30 − M) is exactly 0 (never NaN), and with kv_len = 0
    every split's weight exp(-1e30 + 1e30) is exactly 1. Splitting then
    changes nothing beyond the order of the sums."""
    neg = torch.tensor(NEG)
    for m in (-3.0, 0.0, 0.3, 50.0):
        assert torch.exp(neg - torch.tensor(m)) == 0.0
    assert torch.exp(neg - neg) == 1.0
    args = _inputs(2, 64, 1, 2, 32, 8, [1, 5], 7)
    t = list(map(torch.from_numpy, args))
    one = split_combine(*t, bits=8, length=64, inv_rotate_v=False)
    four = split_combine(*t, bits=8, length=16, inv_rotate_v=False)
    assert torch.isfinite(four).all()
    torch.testing.assert_close(four, one, rtol=1e-6, atol=1e-7)
