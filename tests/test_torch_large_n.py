"""The FWHT and the two encoders above N = 8192, and the flat quantize_pack
stream, on the CPU: the CUDA kernels' index math and order of operations,
modelled in torch in this file, against the port's plain versions and the
JAX reference on the same numpy inputs.

Above N = 8192 the card runs the FWHT as `fwht_plan`'s passes
(`csrc/fwht.cu`, `ndsc_fwht_pass`): a pass of stages [s, s + k) owns tiles
of 2^k values 2^s apart by W = 2^pass_cols(s, k) contiguous columns. The
encoders at N = 2^14 and 2^15 run one kernel (`encode_row_kernel` in
`csrc/quantencode.cu`, route "row"): 32 values a thread in two layouts of
the row, register and shuffle stages, shared-memory exchanges between the
layouts, the pack by an OR-shuffle tree; from 2^16 they run those passes
with their per-value steps folded in, then the flat quantize_pack kernel
with a dither and a row mask, and for the EF residual the flat unpack
kernel and the passes again (`quantencode.py`). Every float step is one
f32 rounding, so each model must be bitwise the plain version; so must
the port's plain versions be the reference's, and
`repro_torch.dist.gradcomp` at chunk 16384 and the `dsc` codec on a leaf
of N 32768 the reference's (payloads bitwise, ledger == audit). The
wrapper checks that used to refuse N > 8192 on a CUDA tensor now choose
a route (tested here without a card)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codecs as jcodecs
from repro.dist import gradcomp as JG
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
def pass_model(src, s, k, lw, *, last, signs_in=None, row_mul=None,
               rescale=None):
    """ndsc_fwht_pass without its store epilogue: tile t_id of the grid
    gathers its 2^k·W values, runs stages s..s+k−1 on them in the kernel's
    shared-memory layout and scatters them back. Returns (out, the flat
    index of every tile element), for a coverage check."""
    rows, n = src.shape
    log2n = n.bit_length() - 1
    w, tile = 1 << lw, 1 << (k + lw)
    tiles_log = log2n - k - lw
    t_id = torch.arange(rows << tiles_log, dtype=torch.int64)
    row, in_row = t_id >> tiles_log, t_id & ((1 << tiles_log) - 1)
    cb_log = s - lw
    col0 = (((in_row >> cb_log) << (s + k))
            + ((in_row & ((1 << cb_log) - 1)) << lw))
    e = torch.arange(tile, dtype=torch.int64)
    col = col0[:, None] + ((e >> lw) << s)[None] + (e & (w - 1))[None]
    flat = row[:, None] * n + col
    sm = src.reshape(-1)[flat]
    if signs_in is not None:
        sm = sm * signs_in[col]
    if row_mul is not None:
        sm = sm * row_mul.reshape(-1)[row][:, None]
        if rescale is not None:
            sm = sm / torch.tensor(rescale, dtype=torch.float32)
    p = torch.arange(tile // 2, dtype=torch.int64)
    for j in range(k):
        q = p >> lw
        t = ((q >> j) << (j + 1)) | (q & ((1 << j) - 1))
        i = (t << lw) | (p & (w - 1))
        a, b = sm[:, i], sm[:, i + (w << j)]
        sm[:, i], sm[:, i + (w << j)] = a + b, a - b
    if last:
        sm = sm * torch.tensor(F.inv_sqrt(n), dtype=torch.float32)
    out = torch.empty_like(src)
    out.reshape(-1)[flat] = sm
    return out, flat


def passes_model(src, **first):
    """`run_passes` without the last pass's store epilogue: `fwht_plan`'s
    passes in order, the first with the given load steps."""
    y = src
    plan = F.fwht_plan(src.shape[-1].bit_length() - 1)
    for i, (s, k) in enumerate(plan):
        y, flat = pass_model(y, s, k, F.pass_cols(s, k),
                             last=i == len(plan) - 1, **(first if i == 0
                                                          else {}))
        assert torch.equal(flat.reshape(-1).sort().values,
                           torch.arange(src.numel()))
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
    """The encoder from 2^16 as `quantencode._passes` launches it (run here
    at 16384, where the passes' index math is the same)."""
    e = passes_model(chunks, signs_in=signs)
    rowmax = e.abs().amax(-1, keepdim=True)         # max: any order, exact
    words, scale = pack_flat_model(e, rowmax, bits, dither, mask)
    if residual_dtype is None:
        return words, scale
    x_hat = tref.unpack_dequant(words, scale, bits, chunks.shape[-1])
    y = passes_model(x_hat, row_mul=mask,
                     rescale=rescale if mask is not None else None)
    y = (y * signs).to(residual_dtype).to(torch.float32)
    return words, scale, chunks - y


# ---------------------------------------------------------------------------
# the pass plan and the FWHT
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("log2n", range(14, 31))
def test_plan_keeps_the_stage_order_and_fits_a_block(log2n):
    """Stages 0..L−1 once each in increasing order; 13 in the first pass
    (contiguous), at most 10 later, with tiles of 2^13..2^15 floats and
    W ≥ 32 (whole 128 B lines); 2^28 in three passes."""
    plan = F.fwht_plan(log2n)
    assert [s for s, k in plan for s in range(s, s + k)] == list(range(log2n))
    assert plan[0] == (0, 13) and F.pass_cols(0, 13) == 0
    for s, k in plan[1:]:
        lw = F.pass_cols(s, k)
        assert 1 <= k <= 10 and 5 <= lw <= s
        assert 13 <= k + lw <= 15
    assert len(plan) == 1 + math.ceil((log2n - 13) / 10)
    assert F.fwht_plan(28) == [(0, 13), (13, 8), (21, 7)]


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
    takes a kernel (the FWHT's passes above 8192; the encoders' row kernel
    at 2^14 and 2^15, their passes from 2^16), other N raise."""
    assert F.fwht_path(8192) == "single"
    for log2n in (14, 15, 16, 20, 23, 26, 28):
        assert F.fwht_path(1 << log2n) == "passes"
    for log2n in (14, 15):
        assert encode_path(1 << log2n) == "row"
    for log2n in (16, 17, 20, 23, 26, 28):
        assert encode_path(1 << log2n) == "passes"
    assert encode_path(32) == encode_path(8192) == "fused"
    for bad in (0, 3, 12288, (1 << 20) + 32):
        with pytest.raises(ValueError, match="power-of-2"):
            F.fwht_path(bad)
    for bad in (16, 12288):
        with pytest.raises(ValueError, match="power-of-2"):
            encode_path(bad)
    assert not hasattr(F, "MAX_N")


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


def row_fwht_model(v, n, done):
    """fwht_low in layout A (register stages for bits 0-1, one shuffle and
    one p + v·(±1) per value for bits 2-6, register stages for bits 7-9),
    the exchange to layout B, fwht_high (bits 10..log2 n − 1) and the one
    multiply by f32(1/√n). v: (rows, T, 32) in layout A; returns layout B.
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
