"""The FWHT and the two encoders above N = 8192, and the flat quantize_pack
stream, on the CPU: the CUDA kernels' index math and order of operations,
modelled in torch in this file, against the port's plain versions and the
JAX reference on the same numpy inputs.

Above N = 8192 the card runs the FWHT as `fwht_plan`'s passes
(`csrc/fwht.cu`, `ndsc_fwht_pass`; one pass, route "row", at 2^14 and
2^15). The first pass is `fwht_row_kernel` on contiguous segments of 2^14
or 2^15: 32 values a thread in two layouts of the segment, register and
shuffle stages, one shared-memory exchange between the layouts
(`csrc/row_fwht.cuh`, the schedule of the encoders' `encode_row_kernel`),
the store from the second layout. A later pass of stages [s, s + k) is
`fwht_cols_kernel<k>` on tiles of 2^13 values, 2^k rows 2^s apart by
W = 2^(13−k) contiguous columns: 32 values a thread, min(k, 5) stages in
registers, and for k > 5 one exchange into a second layout for the rest.
The encoders at N = 2^14 and 2^15 run one kernel (`encode_row_kernel` in
`csrc/quantencode.cu`, route "row"), at 2^16 and 2^17 another
(`encode_cluster_kernel`, route "cluster", modelled in
`tests/test_torch_cluster_encode.py`); above 2^17 they run those passes
with their per-value steps folded in, then the flat quantize_pack kernel with a
dither and a row mask, and for the EF residual the flat unpack kernel and
the passes again (`quantencode.py`). Every float step is one f32
rounding, so each model must be bitwise the plain version; so must the
port's plain versions be the reference's, and `repro_torch.dist.gradcomp`
at chunk 16384 and the `dsc` codec on a leaf of N 32768 the reference's
(payloads bitwise, ledger == audit). The wrapper checks that used to
refuse N > 8192 on a CUDA tensor now choose a route (tested here without a
card)."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro import codecs as jcodecs
from repro.dist import gradcomp as JG
from repro.kernels import fwht as jfwht
from repro.kernels import ref as jref
from repro_torch import codecs as tcodecs
from repro_torch.dist import gradcomp as TG
from repro_torch.kernels import fwht as F
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quantencode import encode_path
from repro_torch.kernels.quantpack import pack_path

MODES = ("det", "dither", "mask", "rescale")
TINY = torch.finfo(torch.float32).tiny


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.int32)


def _inputs(rows, n, bits, seed):
    """x, ±1 signs, a dither in [-Δ/2, Δ/2), a 0/1 row mask (rows 0 and 1
    kept and dropped), row 1 zero but for a spike in its last value."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    signs = np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    delta = 2.0 / 2 ** bits
    dither = ((rng.random((rows, n)) - 0.5) * delta).astype(np.float32)
    mask = (rng.random((rows, 1)) < 0.6).astype(np.float32)
    mask[0], mask[-1] = 1.0, 0.0
    if rows > 1:
        x[1] = 0.0
        x[1, -1] = 2.5
    return x, signs, dither, mask


def _mode(mode, dither, mask):
    d = dither if mode in ("dither", "rescale") else None
    m = mask if mode in ("mask", "rescale") else None
    return d, m, (0.6 if mode == "rescale" else None)


# ---------------------------------------------------------------------------
# kernel models
# ---------------------------------------------------------------------------
def _finish(y, flat, n, signs_out=None, sub_from=None, round_bf16=False):
    """The last pass's store epilogue (fwht.cu `finish`): × f32(1/√n),
    × signs_out at the position, the bf16 rounding, sub_from − y. The
    row maximum of |y| (before the signs) is exact in any order, so the
    models take it from the stored FWHT where an encoder needs it."""
    y = y * torch.tensor(F.inv_sqrt(n), dtype=torch.float32)
    if signs_out is not None:
        y = y * signs_out[flat % n]
    if round_bf16:
        y = y.to(torch.bfloat16).to(torch.float32)
    if sub_from is not None:
        y = sub_from.reshape(-1)[flat] - y
    return y


def row_pass_model(src, log2l, *, last, signs_in=None, row_mul=None,
                   rescale=None, **store):
    """fwht_row_kernel<log2l>: each contiguous segment of 2^log2l values
    loaded in layout A (× signs_in at its positions, × row_mul[row],
    ÷ rescale), `row_fwht_model`'s schedule, the store from layout B
    (thread t writes t + T·r: each warp store 32 consecutive floats), with
    the last pass's epilogue. Returns (out, the flat index of every value
    stored), for a coverage check."""
    rows, n = src.shape
    seg_n = 1 << log2l
    a, b = row_layouts(seg_n)
    seg = torch.arange(rows * n // seg_n, dtype=torch.int64)
    row, col = seg // (n // seg_n), (seg % (n // seg_n)) * seg_n
    v = src.reshape(-1, seg_n)[:, a]
    if signs_in is not None:
        v = v * signs_in[col[:, None, None] + a[None]]
    if row_mul is not None:
        v = v * row_mul.reshape(-1)[row][:, None, None]
        if rescale is not None:
            v = v / torch.tensor(rescale, dtype=torch.float32)
    v = row_fwht_model(v, seg_n, [], scale=False)
    flat = (row * n + col)[:, None, None] + b[None]
    if last:
        v = _finish(v, flat, n, **store)
    out = torch.empty_like(src)
    out.reshape(-1)[flat] = v
    return out, flat


COLS_TILE_LOG2 = 13        # fwht_cols_kernel's tile: 2^13 values
COLS_THREADS = 256


def cols_layouts(k):
    """fwht_cols_kernel<k>'s two layouts of a tile of 2^13 values, 256
    threads by 32 registers: the tile element (row e >> (13 − k), column
    e & (W − 1)) each holds. L1 (loads, the first min(k, 5) stages):
    registers are rows 0..4 (and below k = 5 columns 5..9 − k too), the
    lane columns 0..4; L2 (k > 5: the other stages and the stores):
    registers rows 5..k − 1 (low bits) and 0..9 − k, the lane columns
    0..4. None for L2 where k ≤ 5."""
    lw = COLS_TILE_LOG2 - k
    t = torch.arange(COLS_THREADS)
    lane, warp = t & 31, t >> 5
    i = torch.arange(ROW_V)
    kr = min(k, 5)
    if k >= 5:
        e1 = (lane + ((warp & ((1 << (8 - k)) - 1)) << 5)
              + ((warp >> (8 - k)) << (lw + 5)))
    else:
        e1 = lane + (warp << (10 - k))
    l1 = e1[:, None] + (((i & ((1 << kr) - 1)) << lw) + ((i >> kr) << 5))[None]
    if k <= 5:
        return l1, None
    e2 = (lane + ((warp & ((1 << (8 - k)) - 1)) << 5)
          + ((warp >> (8 - k)) << (lw + 10 - k)))
    off2 = ((i >> (k - 5)) << lw) + ((i & ((1 << (k - 5)) - 1)) << (lw + 5))
    return l1, e2[:, None] + off2[None]


def cols_pass_model(src, s, k, *, last, done=None, **store):
    """fwht_cols_kernel<k>, stages s..s+k−1: tile t of the grid gathers
    its 2^13 values in layout L1, runs min(k, 5) register stages, for
    k > 5 exchanges into L2 and runs the rest, and stores from the last
    layout with the last pass's epilogue. Returns (out, flat indices)."""
    rows, n = src.shape
    log2n = n.bit_length() - 1
    lw = F.pass_cols(s, k)
    assert lw == COLS_TILE_LOG2 - k
    tiles_log, cb_log = log2n - COLS_TILE_LOG2, s - lw
    t = torch.arange(rows << tiles_log, dtype=torch.int64)
    row, ti = t >> tiles_log, t & ((1 << tiles_log) - 1)
    col0 = (((ti >> cb_log) << (s + k))
            + ((ti & ((1 << cb_log) - 1)) << lw))
    base = (row * n + col0)[:, None, None]

    def pos(e):            # tile element → position relative to col0
        return ((e >> lw) << s) + (e & ((1 << lw) - 1))

    done = [] if done is None else done
    l1, l2 = cols_layouts(k)
    v = src.reshape(-1)[base + pos(l1)[None]]
    for q in range(min(k, 5)):
        v = _reg_stage(v, pos(l1), 1 << q, done)
    lay = l1
    if l2 is not None:
        v = _exchange(v, l1, l2, 1 << COLS_TILE_LOG2)
        for q in range(k - 5):
            v = _reg_stage(v, pos(l2), 1 << q, done)
        lay = l2
    flat = base + pos(lay)[None]
    if last:
        v = _finish(v, flat, n, **store)
    out = torch.empty_like(src)
    out.reshape(-1)[flat] = v
    return out, flat


def passes_model(src, *, signs_in=None, row_mul=None, rescale=None,
                 signs_out=None, sub_from=None, round_bf16=False):
    """`run_passes`: `fwht_plan`'s passes in order, the first
    (fwht_row_kernel) with the load steps, the last with the store
    steps; every pass stores each value once."""
    y = src
    plan = F.fwht_plan(src.shape[-1].bit_length() - 1)
    for i, (s, k) in enumerate(plan):
        last = i == len(plan) - 1
        store = (dict(signs_out=signs_out, sub_from=sub_from,
                      round_bf16=round_bf16) if last else {})
        if s == 0:
            y, flat = row_pass_model(y, k, last=last, signs_in=signs_in,
                                     row_mul=row_mul, rescale=rescale,
                                     **store)
        else:
            y, flat = cols_pass_model(y, s, k, last=last, **store)
        assert bool((torch.bincount(flat.reshape(-1), minlength=src.numel())
                     == 1).all())
    return y


def quantize_code(v, denom, bits):
    """ndsc::quantize_code: clip(floor((clip(v / denom, −1, 1) + 1) ·
    2^(bits−1)), 0, 2^bits − 1)."""
    q = torch.clamp(v / denom, -1.0, 1.0)
    idx = torch.floor((q + 1.0) * float(2 ** (bits - 1)))
    return torch.clamp(idx, 0, 2 ** bits - 1).to(torch.int64)


def pack_flat_model(x, scale, bits, dither=None, mask=None):
    """quantize_flat_kernel: thread f quantizes float4 f into its field of
    word f / F4, the F4 fields ORed; a masked word is multiplied by the
    int32 mask, and the word that opens a row writes scale·mask. Returns
    (words int32 (rows, wpr), scale_out (rows, 1))."""
    rows, n = x.shape
    wpr, f4 = n * bits // 32, 8 // bits
    assert pack_path(n, bits) == "flat"
    f = torch.arange(rows * n // 4, dtype=torch.int64)
    wi = f >> (f4.bit_length() - 1)
    row = wi >> (wpr.bit_length() - 1)
    s = scale.reshape(-1)[row][:, None]
    v = x.reshape(-1, 4)
    if dither is not None:
        v = v + dither.reshape(-1, 4) * s
    code = quantize_code(v, torch.clamp_min(s, TINY), bits)
    sh = ((f & (f4 - 1)) * 4 * bits)[:, None] + torch.arange(4) * bits
    part = (code << sh).sum(-1)
    word = part.reshape(-1, f4).sum(-1)          # disjoint fields: OR = sum
    s_row = scale.reshape(rows, 1)
    if mask is not None:
        word = word * mask.reshape(-1).to(torch.int64)[row[::f4]]
        s_row = s_row * mask
    return tref.to_int32(word & 0xFFFFFFFF).reshape(rows, wpr), s_row


def encode_model(chunks, signs, bits, dither=None, mask=None, rescale=None,
                 residual_dtype=None):
    """The encoder from 2^16 as `quantencode._passes` launches it; at
    16384 `run_passes` is one pass of the row kernel with the load and
    the store steps both (the wrappers send 16384 to encode_row_kernel,
    but the passes take it)."""
    e = passes_model(chunks, signs_in=signs)
    rowmax = e.abs().amax(-1, keepdim=True)         # max: any order, exact
    words, scale = pack_flat_model(e, rowmax, bits, dither, mask)
    if residual_dtype is None:
        return words, scale
    return words, scale, ef_residual_model(chunks, signs, words, scale,
                                           bits, mask, rescale,
                                           residual_dtype)


def ef_residual_model(chunks, signs, words, scale, bits, mask=None,
                      rescale=None, residual_dtype=torch.float32):
    """encode_ef's residual from 2^16 as `quantencode._passes` forms it:
    the flat unpack, then the passes with the row mask and rescale at the
    first loads and the signs, the rounding and u − y at the last stores."""
    x_hat = tref.unpack_dequant(words, scale, bits, chunks.shape[-1])
    return passes_model(x_hat, row_mul=mask,
                        rescale=rescale if mask is not None else None,
                        signs_out=signs, sub_from=chunks,
                        round_bf16=residual_dtype == torch.bfloat16)


# ---------------------------------------------------------------------------
# the pass plan and the FWHT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("log2n", range(14, 31))
def test_plan_keeps_the_stage_order_and_fits_a_block(log2n):
    """Stages 0..L−1 once each in increasing order; up to 15 in the first
    pass (contiguous segments, the row kernel), at most 8 later, with
    tiles of 2^13 floats and W ≥ 32 (whole 128 B lines) within the
    2^s values a pair spans; 2^28 in three passes."""
    plan = F.fwht_plan(log2n)
    assert [s for s, k in plan for s in range(s, s + k)] == list(range(log2n))
    assert plan[0] == (0, min(log2n, 15)) and F.pass_cols(*plan[0]) == 0
    for s, k in plan[1:]:
        lw = F.pass_cols(s, k)
        assert 1 <= k <= 8 and 5 <= lw <= s
        assert k + lw == 13
    assert len(plan) == 1 + math.ceil(max(0, log2n - 15) / 8)
    assert F.fwht_plan(28) == [(0, 15), (15, 7), (22, 6)]


@pytest.mark.parametrize("log2n,rows", [(14, 3), (17, 2), (20, 1)])
def test_passes_bitwise_plain_and_jax(log2n, rows):
    n = 1 << log2n
    x = np.random.default_rng(log2n).standard_normal((rows, n)).astype(
        np.float32)
    got = passes_model(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(tref.fwht(
        torch.from_numpy(x))))
    # compiled once per shape rather than op by op: the FWHT has no
    # multiply feeding an add, so XLA has nothing to contract into an FMA
    np.testing.assert_array_equal(_bits(got), _bits(jax.jit(jref.fwht)(
        jnp.asarray(x))))


def test_cuda_paths_above_8192_do_not_refuse():
    """What the CUDA wrappers check before a launch: every power of two
    takes a kernel (the FWHT's row kernel at 2^14 and 2^15, its passes
    from 2^16; the encoders' row kernel at 2^14 and 2^15, their cluster
    kernel at 2^16 and 2^17, their passes above), other N raise."""
    assert F.fwht_path(8192) == "single"
    for log2n in (14, 15):
        assert F.fwht_path(1 << log2n) == "row"
        assert F.fwht_plan(log2n) == [(0, log2n)]
    for log2n in (16, 20, 23, 26, 28):
        assert F.fwht_path(1 << log2n) == "passes"
    for log2n in (14, 15):
        assert encode_path(1 << log2n) == "row"
    for log2n in (16, 17):
        assert encode_path(1 << log2n) == "cluster"
    for log2n in (18, 20, 23, 26, 28):
        assert encode_path(1 << log2n) == "passes"
    assert encode_path(32) == encode_path(8192) == "fused"
    for bad in (0, 3, 12288, (1 << 20) + 32):
        with pytest.raises(ValueError, match="power-of-2"):
            F.fwht_path(bad)
    for bad in (16, 12288):
        with pytest.raises(ValueError, match="power-of-2"):
            encode_path(bad)
    assert not hasattr(F, "MAX_N")


def _pallas_fwht(x):
    """The reference's Pallas FWHT (`repro.kernels.fwht._fwht_kernel`, the
    body of fwht_pallas's pl.pallas_call) in interpret mode, as
    tests/test_kernels.py runs it, on one block of all the rows: its
    wrapper refuses N > 8192, a TPU VMEM budget, which the body does not
    depend on."""
    rows, n = x.shape
    spec = pl.BlockSpec((rows, n), lambda i: (0, 0))
    return pl.pallas_call(functools.partial(jfwht._fwht_kernel, n=n),
                          grid=(1,), in_specs=[spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct((rows, n),
                                                         jnp.float32),
                          interpret=True)(jnp.asarray(x))


@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("log2n", [14, 15])
def test_fwht_row_route_model_bitwise_plain_and_pallas(log2n, rows,
                                                       one_thread):
    """The "row" route, one launch of fwht_row_kernel: the row_fwht_model
    schedule and the store from layout B, bitwise ref.fwht and the
    reference's Pallas kernel."""
    n = 1 << log2n
    x = np.random.default_rng(log2n * 10 + rows).standard_normal(
        (rows, n)).astype(np.float32)
    got, flat = row_pass_model(torch.from_numpy(x), log2n, last=True)
    assert torch.equal(flat.reshape(-1).sort().values, torch.arange(x.size))
    assert F.fwht_plan(log2n) == [(0, log2n)]
    np.testing.assert_array_equal(_bits(got), _bits(tref.fwht(
        torch.from_numpy(x))))
    np.testing.assert_array_equal(_bits(got), _bits(_pallas_fwht(x)))


@pytest.mark.parametrize("k", range(1, 9))
def test_cols_layouts_cover_the_tile_and_keep_the_stage_order(k):
    """fwht_cols_kernel<k>: each layout holds every tile element once; the
    register stages pair rows 2^s·2^q apart for q = 0..k−1, in increasing
    order; every register of a warp holds 32 consecutive elements (the
    loads, the stores and the exchange are 128 B a warp, free of bank
    conflicts); the staged tile is 2^k runs of W contiguous floats."""
    l1, l2 = cols_layouts(k)
    for lay in (l1, l2):
        if lay is None:
            continue
        assert torch.equal(lay.reshape(-1).sort().values,
                           torch.arange(1 << COLS_TILE_LOG2))
        warps = lay.reshape(-1, 32, ROW_V)
        assert torch.equal(warps - warps[:, :1], torch.arange(32)[None, :,
                                                                  None]
                           .expand_as(warps))
    assert (l2 is None) == (k <= 5)
    s = 15
    x = torch.zeros(1, 1 << (s + k))
    done = []
    cols_pass_model(x, s, k, last=False, done=done)
    assert done == [1 << q for q in range(s, s + k)]


# the reference's encoders compiled as one program with XLA's fusion pass
# off, where each op rounds as written, as its eager ops do
# (tests/test_torch_dist.py); eagerly each op compiles per new shape, for
# seconds a shape at these N
UNFUSED = {"xla_disable_hlo_passes": "fusion",
           "xla_backend_optimization_level": 0}


def _unfused(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=UNFUSED)(*args)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("log2n", [16, 17, 20])
def test_passes_model_folds_bitwise_plain_and_jax(log2n, mode, one_thread):
    """The passes from 2^16 in every fold mode of PassArgs, through the
    encoders that fold them (`quantencode._passes`): the signs and the row
    maximum (encode), the row mask and rescale at the first loads and the
    signs, the bf16 rounding and the subtract at the last stores (the EF
    residual, f32 and bf16), against ref.encode / encode_ef and the
    reference's; on 2 rows (the second zero but for a spike in its last
    value, and masked), at 2^20 on one row, kept."""
    n, bits = 1 << log2n, {"det": 1, "dither": 2, "mask": 4, "rescale": 8}[mode]
    rows = 1 if log2n == 20 else 2
    x, signs, dither, mask = _inputs(rows, n, bits, log2n * 10 + bits)
    mask[0] = 1.0
    d, m, rescale = _mode(mode, dither, mask)
    t = [None if v is None else torch.from_numpy(v)
         for v in (x, signs, d, m)]
    j = [None if v is None else jnp.asarray(v) for v in (x, signs, d, m)]
    # rescale as an argument: XLA turns a division by a constant into a
    # multiply by its reciprocal
    jout = _unfused(lambda u, s, dd, mm, rs: [jref.encode_ef(
        u, s, bits, dither=dd, mask=mm, rescale=rs, residual_dtype=dt)
        for dt in (jnp.float32, jnp.bfloat16)], *j,
        None if rescale is None else jnp.float32(rescale))
    mw, ms, mr = encode_model(t[0], t[1], bits, t[2], t[3], rescale,
                              torch.float32)
    tw, ts = tref.encode(t[0], t[1], bits, dither=t[2], mask=t[3])
    for tdt, (jw, js, jr) in zip((torch.float32, torch.bfloat16), jout):
        for w, sc in ((tw, ts), (mw, ms)):
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
            np.testing.assert_array_equal(_bits(sc), _bits(js))
        _, _, tr = tref.encode_ef(t[0], t[1], bits, dither=t[2], mask=t[3],
                                  rescale=rescale, residual_dtype=tdt)
        if tdt == torch.bfloat16:
            mr = ef_residual_model(t[0], t[1], mw, ms, bits, t[3], rescale,
                                   tdt)
        np.testing.assert_array_equal(_bits(tr), _bits(jr))
        np.testing.assert_array_equal(_bits(mr), _bits(jr))


# ---------------------------------------------------------------------------
# quantize_pack as a flat float4 stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [32, 128, 256, 8192, 16384])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_flat_model_bitwise_plain_and_jax(bits, n):
    """Scales above and below the rows' maxima (the clip acts), one at 0
    (the FLT_MIN guard), one row whose maximum sits in its last lane."""
    rng = np.random.default_rng(n + bits)
    x = rng.standard_normal((9, n)).astype(np.float32)
    x[4, -1] = 9.0
    scale = (np.abs(x).max(-1, keepdims=True)
             * (0.5 + rng.random((9, 1)))).astype(np.float32)
    scale[3] = 0.0
    scale[4] = 9.0
    words, _ = pack_flat_model(torch.from_numpy(x), torch.from_numpy(scale),
                               bits)
    want = tref.quantize_pack(torch.from_numpy(x), torch.from_numpy(scale),
                              bits)
    np.testing.assert_array_equal(words.numpy(), want.numpy())
    np.testing.assert_array_equal(words.numpy(), np.asarray(
        jref.quantize_pack(jnp.asarray(x), jnp.asarray(scale), bits)))


def test_pack_path_choice():
    """Flat exactly where wpr is a power of two: 12288 (the sweep's odd
    width) takes the row kernel at every R."""
    for bits in (1, 2, 4, 8):
        for n in (32, 128, 256, 8192, 16384, 1 << 28):
            assert pack_path(n, bits) == "flat"
        assert pack_path(12288, bits) == "rows"
        assert pack_path(96, bits) == "rows"


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_flat_model_with_dither_and_mask_is_the_encoders_tail(bits):
    """The tail of ref.encode: e + dither·scale quantized against the
    unmasked scale, masked rows' words zero and scale·mask."""
    n = 256
    x, _, dither, mask = _inputs(6, n, bits, bits)
    e, d, m = map(torch.from_numpy, (x, dither, mask))
    scale = e.abs().amax(-1, keepdim=True)
    words, s_out = pack_flat_model(e, scale, bits, d, m)
    want_w = tref.quantize_pack(e + d * scale, scale, bits) * m.to(
        torch.int32)
    assert torch.equal(words, want_w)
    assert torch.equal(s_out, scale * m)
    assert not words[m.reshape(-1) == 0].any()


# ---------------------------------------------------------------------------
# the encoders above 8192
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_encoders_at_16384_bitwise_jax(bits, mode):
    """The port's ref.encode / ref.encode_ef against the reference's, f32
    and bf16 residuals, and the passes' model against both."""
    x, signs, dither, mask = _inputs(3, 16384, bits, bits * 10 + len(mode))
    d, m, rescale = _mode(mode, dither, mask)
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, signs, d, m)]
    j = [None if a is None else jnp.asarray(a) for a in (x, signs, d, m)]
    jw, js = jref.encode(j[0], j[1], bits, dither=j[2], mask=j[3])
    tw, ts = tref.encode(t[0], t[1], bits, dither=t[2], mask=t[3])
    mw, ms = encode_model(t[0], t[1], bits, t[2], t[3])
    for w, s in ((tw, ts), (mw, ms)):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(_bits(s), _bits(js))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        _, _, jr = jref.encode_ef(j[0], j[1], bits, dither=j[2], mask=j[3],
                                  rescale=rescale, residual_dtype=jdt)
        _, _, tr = tref.encode_ef(t[0], t[1], bits, dither=t[2], mask=t[3],
                                  rescale=rescale, residual_dtype=tdt)
        _, _, mr = encode_model(t[0], t[1], bits, t[2], t[3], rescale, tdt)
        np.testing.assert_array_equal(_bits(tr), _bits(jr))
        np.testing.assert_array_equal(_bits(mr), _bits(jr))


@pytest.mark.parametrize("dither,keep", [(False, 1.0), (True, 0.5)])
def test_gradcomp_at_chunk_16384_bitwise_jax(dither, keep):
    """encode_leaf_ef and decode_leaf of a 40,000-value leaf (3 chunks of
    16384, the last padded) against repro.dist.gradcomp."""
    kw = dict(bits=4, chunk=16384, dithered=dither, keep_fraction=keep,
              exact_keep=True, error_feedback=not dither)
    jc, tc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    x = np.random.default_rng(7).standard_normal((200, 200)).astype(
        np.float32)
    jp, jr = JG.encode_leaf_ef(jnp.asarray(x), 2, jc, 3)
    tp, tr = TG.encode_leaf_ef(torch.from_numpy(x), 2, tc, 3)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]))
    np.testing.assert_array_equal(_bits(tr), _bits(jr))
    jd = JG.decode_leaf(jp, 2, x.size, x.shape, jnp.float32, jc)
    td = TG.decode_leaf(tp, 2, x.size, x.shape, torch.float32, tc)
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    tree = {"x": torch.from_numpy(x)}
    audit = TG.wire_bytes_tree(tree, tc)["payload_bytes"]
    ledger = TG.wire_bytes_payload(TG.compress_tree(tree, tc, 3)[0], tc)
    assert ledger == audit == JG.wire_bytes_tree(
        {"x": jnp.asarray(x)}, jc)["payload_bytes"]


@pytest.mark.parametrize("budget", [0.5, 2.0])
def test_dsc_on_a_leaf_of_n_32768_bitwise_jax(budget):
    """One Hadamard frame of N 32768 for a 20,000-value leaf: codewords,
    scale and mask, the decode, and the ledger (equal to the audit at
    R 2, where the wire has a fixed size) as the reference's."""
    x = np.random.default_rng(11).standard_normal(20_000).astype(
        np.float32)
    jc, tc = jcodecs.make("dsc", budget), tcodecs.make("dsc", budget)
    k = jax.random.key(5)
    tk = torch.from_numpy(np.asarray(jax.random.key_data(k)).astype(
        np.int64))
    jt, tt = {"x": jnp.asarray(x)}, {"x": torch.from_numpy(x)}
    jw, tw = jc.encode(k, jt, 2), tc.encode(tk, tt, 2)
    assert sorted(jw["x"]) == sorted(tw["x"])
    for key in jw["x"]:
        np.testing.assert_array_equal(_bits(tw["x"][key]),
                                      _bits(jw["x"][key]))
    jm, tm = jc.meta(jt), tc.meta(tt)
    np.testing.assert_array_equal(_bits(tc.decode(tw, tm)["x"]),
                                  _bits(jc.decode(jw, jm)["x"]))
    assert tc.wire_bytes(tw, tm) == jc.wire_bytes(jw, jm)
    assert tc.wire_bits(tt) == jc.wire_bits(jt)
    if budget >= 1.0:
        assert tc.wire_bytes(tw, tm) == tc.wire_bits(tt) / 8


# ---------------------------------------------------------------------------
# the "row" route at 2^14 and 2^15: encode_row_kernel's schedule
# ---------------------------------------------------------------------------
ROW_V = 32                 # values a thread holds


def row_layouts(n):
    """encode_row_kernel's two layouts of a row of n, T = n/32 threads: the
    position each thread's register holds. A[t, 4j + c] = 4·lane + 128·j +
    1024·warp + c (loads, dither, pack, decode); B[t, r] = t + T·r (the
    top stages, the row maximum, the residual)."""
    t = torch.arange(n // ROW_V)
    lane, warp = t & 31, t >> 5
    i = torch.arange(ROW_V)
    a = ((i & 3)[None] + 4 * lane[:, None] + 128 * (i >> 2)[None]
         + 1024 * warp[:, None])
    b = t[:, None] + (n // ROW_V) * i[None]
    return a, b


def _reg_stage(v, pos, h, done):
    """Butterflies between registers i and i + h (i & h == 0) of every
    thread; checks that they pair position p with p + 2^bit and records
    the bit in `done`."""
    i = torch.tensor([i for i in range(ROW_V) if not i & h])
    bit = int(pos[0, i[0] + h] - pos[0, i[0]])
    assert bit & (bit - 1) == 0 and torch.equal(pos[:, i + h], pos[:, i] + bit)
    done.append(bit)
    lo, hi = v[..., i], v[..., i + h]
    v = v.clone()
    v[..., i], v[..., i + h] = lo + hi, lo - hi
    return v


def _exchange(v, src, dst, n):
    """Through the shared buffer: every thread stores its registers at the
    positions `src` gives, then loads those `dst` gives."""
    buf = torch.full((v.shape[0], n), float("nan"))
    buf[:, src] = v
    return buf[:, dst]


def row_fwht_model(v, n, done, scale=True):
    """fwht_low in layout A (register stages for bits 0-1, one shuffle and
    one p + v·(±1) per value for bits 2-6, register stages for bits 7-9),
    the exchange to layout B, fwht_high (bits 10..log2 n − 1) and, where
    `scale`, the one multiply by f32(1/√n). v: (rows, T, 32) in layout A; returns layout B.
    The position bits of the stages, in order, are appended to `done`."""
    a, b = row_layouts(n)
    tid = torch.arange(n // ROW_V)
    for h in (1, 2):
        v = _reg_stage(v, a, h, done)
    for o in (1, 2, 4, 8, 16):
        partner = tid ^ o                  # __shfl_xor_sync(…, o)
        assert torch.equal(a[partner], a ^ (4 * o))
        done.append(4 * o)
        sgn = torch.where(tid & o != 0, -1.0, 1.0)[:, None]
        v = v[:, partner] + v * sgn       # fma(v, ±1, p): one rounding
    for h in (4, 8, 16):
        v = _reg_stage(v, a, h, done)
    v = _exchange(v, a, b, n)
    log2t = (n // ROW_V).bit_length() - 1
    for q in range(10 - log2t, 5):
        v = _reg_stage(v, b, 1 << q, done)
    if not scale:
        return v
    return v * torch.tensor(F.inv_sqrt(n), dtype=torch.float32)


def row_encode_model(chunks, signs, bits, dither=None, mask=None,
                     rescale=None, residual_dtype=None):
    """encode_row_kernel on each row: the load in layout A, × signs, the
    FWHT, the row maximum (exact in any order), the exchange back to A,
    the dither, each lane's codes at their bit offsets, the OR-shuffle tree
    over the k/4 lanes of a word, the mask, the store by the first lane;
    for the residual the decode of each lane's codes from its masked word,
    the FWHT again and u − y in layout B (u loaded again)."""
    rows, n = chunks.shape
    a, b = row_layouts(n)
    tid = torch.arange(n // ROW_V)
    k = 32 // bits
    v = row_fwht_model(chunks[:, a] * signs[a], n, [])
    scale = v.abs().amax((1, 2))[:, None, None]
    v = _exchange(v, b, a, n)
    if dither is not None:
        v = v + dither[:, a] * scale
    code = quantize_code(v, torch.clamp_min(scale, TINY), bits)
    shift = ((4 * tid) % k * bits)[:, None] + (torch.arange(ROW_V) & 3) * bits
    fields = (code << shift).reshape(rows, -1, 8, 4)
    w = fields[..., 0] | fields[..., 1] | fields[..., 2] | fields[..., 3]
    o = 1
    while o < k // 4:                     # the OR-shuffle tree
        w = w | w[:, tid ^ o]
        o <<= 1
    mk = (torch.ones(rows, 1, 1) if mask is None
          else mask.reshape(rows, 1, 1))
    s_out = scale * mk if mask is not None else scale
    if mask is not None:
        w = w * mk.to(torch.int64)        # the int32 product, wrapping
    first = tid % (k // 4) == 0
    slot = a[first][:, ::4] // k          # the word each first lane stores
    assert torch.equal(slot.reshape(-1).sort().values,
                       torch.arange(n // k))
    words = torch.empty(rows, n // k, dtype=torch.int64)
    words[:, slot] = w[:, first]
    words = tref.to_int32(words & 0xFFFFFFFF)
    if residual_dtype is None:
        return words, s_out.reshape(rows, 1)
    idx = (w.repeat_interleave(4, dim=-1) >> shift) & (2 ** bits - 1)
    xh = (-1.0 + (2.0 * idx.to(torch.float32) + 1.0) * 2.0 ** -bits) * s_out
    if mask is not None:
        xh = xh * mk
        if rescale is not None:
            xh = xh / torch.tensor(rescale, dtype=torch.float32)
    y = row_fwht_model(xh, n, []) * signs[b]
    y = y.to(residual_dtype).to(torch.float32)
    resid = torch.empty_like(chunks)
    resid[:, b] = chunks[:, b] - y
    return words, s_out.reshape(rows, 1), resid


@pytest.fixture
def one_thread():
    """The row model is hundreds of small ops; where several test workers
    share the cores, each op's OpenMP threads spin against the others' and
    a case slows a hundredfold, so it runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("log2n", [14, 15])
def test_row_layouts_cover_the_row_and_keep_the_stage_order(log2n,
                                                            one_thread):
    """Each layout holds every position once; the stages run position bits
    0..log2 n − 1 once each in increasing order (ref.fwht's); the
    exchange's float4 stores and scalar loads touch consecutive addresses
    across a warp (no bank conflicts); the staged warps (the TMA copy of the
    row's first half) hold exactly the positions below n/2."""
    n = 1 << log2n
    a, b = row_layouts(n)
    for lay in (a, b):
        assert torch.equal(lay.reshape(-1).sort().values, torch.arange(n))
    done = []
    row_fwht_model(torch.zeros(1, n // ROW_V, ROW_V), n, done)
    assert done == [1 << q for q in range(log2n)]
    warps = a.reshape(-1, 32, ROW_V)
    assert torch.equal(warps[:, 1:, ::4] - warps[:, :-1, ::4],
                       torch.full_like(warps[:, 1:, ::4], 4))
    assert torch.equal(b[1:] - b[:-1], torch.ones_like(b[1:]))
    staged = (a[:, 0] < n // 2).reshape(-1, 32)
    assert bool((staged.all(1) | ~staged.any(1)).all())   # whole warps
    assert torch.equal(a[staged.reshape(-1)].reshape(-1).sort().values,
                       torch.arange(n // 2))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("log2n", [14, 15])
def test_row_route_model_bitwise_plain_and_jax(log2n, bits, mode,
                                               one_thread):
    """encode_row_kernel's model against ref.encode / ref.encode_ef and
    the reference's encode_ef (f32 and bf16 residuals; its words and scale
    are its encode's), on 3 rows (the middle one zero but for a spike in
    its last value; the last one masked)."""
    n = 1 << log2n
    x, signs, dither, mask = _inputs(3, n, bits, log2n * 100 + bits * 10
                                     + len(mode))
    d, m, rescale = _mode(mode, dither, mask)
    t = [None if v is None else torch.from_numpy(v)
         for v in (x, signs, d, m)]
    j = [None if v is None else jnp.asarray(v) for v in (x, signs, d, m)]
    tw, ts = tref.encode(t[0], t[1], bits, dither=t[2], mask=t[3])
    mw, ms = row_encode_model(t[0], t[1], bits, t[2], t[3])
    assert torch.equal(mw, tw) and torch.equal(ms.view(torch.int32),
                                               ts.view(torch.int32))
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        jw, js, jr = jref.encode_ef(j[0], j[1], bits, dither=j[2],
                                    mask=j[3], rescale=rescale,
                                    residual_dtype=jdt)
        _, _, tr = tref.encode_ef(t[0], t[1], bits, dither=t[2], mask=t[3],
                                  rescale=rescale, residual_dtype=tdt)
        mw2, ms2, mr = row_encode_model(t[0], t[1], bits, t[2], t[3],
                                        rescale, tdt)
        for w in (tw, mw2):
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        for sc in (ts, ms2):
            np.testing.assert_array_equal(_bits(sc), _bits(js))
        np.testing.assert_array_equal(_bits(tr), _bits(jr))
        np.testing.assert_array_equal(_bits(mr), _bits(jr))
