"""The encoders' "cluster" route (N = 2^16 and 2^17) on the CPU: the schedule
of `encode_cluster_kernel` (`csrc/quantencode.cu`), modelled in torch,
against the port's plain versions and the JAX reference on the same numpy
inputs.

A row of N = C·2^14 belongs to a cluster of C CTAs; CTA r loads segment r
in the row kernel's layout A and runs its stages below 2^14
(`row_fwht_model` without the multiply), ending in layout B: thread t's
register q holds in-segment position t + T·q in every CTA. The top log2(C)
stages pair values of different CTAs. The kernel ("transpose") runs one
exchange: CTA r reads piece r (P = 2^14/C positions) of every segment,
register s·I + i (I = 32/C) from CTA s's register r·I + i (layout X), and
runs the stages over the segments in registers. Its variant ("pairwise")
exchanges with the partner CTA r ^ 2^j a stage, keeping v + p or
p + v·(−1), each CTA its own segment. Then the multiply by f32(1/√N), the
row maximum as the maximum of the CTAs' maxima, the row kernel's exchange
back to layout A over the CTA's values (its pieces, or its segment), the
dither, the quantizer, the OR-shuffle pack into whole words of the CTA's
own positions and the mask. The EF residual decodes the CTA's own
segment's codes from the row's words, runs the same stages and forms
u − y in layout X. Every float step is one f32 rounding, so the model must
be bitwise `ref.encode` / `ref.encode_ef` and the reference's (compiled
without XLA's fusion pass); so must `repro_torch.dist.gradcomp` at chunk
65536 be the reference's."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import gradcomp as JG
from repro.kernels import ref as jref
from repro_torch.dist import gradcomp as TG
from repro_torch.kernels import fwht as F
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quantencode import CLUSTER_MAX_N, encode_path
from test_torch_large_n import (MODES, ROW_V, TINY, _bits, _exchange,
                                _inputs, _mode, _reg_stage, _unfused,
                                quantize_code, row_fwht_model, row_layouts)
from test_torch_large_n import one_thread  # noqa: F401  (a fixture)

SEG = 1 << 14              # the segment a CTA holds (kClusterSeg = 14)
T = SEG // ROW_V           # threads a CTA
DESIGNS = ("transpose", "pairwise")


def cluster_layouts(n, design="transpose"):
    """Row positions, (C, T, 32) each, of every CTA's layouts: A and B of
    its own segment (the load, the stages below 2^14), and after the top
    stages X (registers; B for "pairwise") and A2 (after the exchange back
    to layout A: the stores, the dither, the pack). A CTA's buffer index l
    then sits at ClusterLayout::pos: piece l // P at offset l % P, piece
    s being piece r of segment s (transpose) or the CTA's segment."""
    c = n // SEG
    p = SEG // c if design == "transpose" else SEG
    a, b = row_layouts(SEG)
    r = torch.arange(c)[:, None, None]

    def pos(l):
        return (l // p) * SEG + r * p + l % p

    return r * SEG + a[None], r * SEG + b[None], pos(b[None]), pos(a[None])


def top_stages(v, n, design="transpose", done=None):
    """The stages h = 2^14, 2^15, ... on v (rows, C, T, 32) in layout B:
    the transposing exchange and the register stages over the segments,
    or one exchange a stage with the partner CTA."""
    c = n // SEG
    rank = torch.arange(c)
    done = [] if done is None else done
    if design == "pairwise":
        h = 1
        while h < c:
            done.append(SEG * h)
            sgn = torch.where(rank & h != 0, -1.0, 1.0)[None, :, None, None]
            v = v[:, rank ^ h] + v * sgn       # fma(v, ±1, p)
            h <<= 1
        return v
    i_ = ROW_V // c
    q = torch.arange(ROW_V)
    # register s·I + i of CTA r ← register r·I + i of CTA s
    src_cta = (q // i_)[None, :].expand(c, ROW_V)
    src_reg = rank[:, None] * i_ + (q % i_)[None, :]
    v = v.permute(0, 2, 1, 3)[:, :, src_cta, src_reg].permute(0, 2, 1, 3)
    _, _, x, _ = cluster_layouts(n)
    h = i_
    while h < ROW_V:
        v = torch.stack([_reg_stage(v[:, r], x[r], h, done if r == 0
                                    else []) for r in range(c)], 1)
        h <<= 1
    return v


def cluster_fwht_model(v, n, design="transpose", done=None):
    """v (rows, C, T, 32) in layout A of each segment → the FWHT in layout
    X, multiplied once by f32(1/√n) after every stage."""
    rows, c = v.shape[:2]
    seg_done = [] if done is None else done
    v = row_fwht_model(v.reshape(rows * c, *v.shape[2:]), SEG, seg_done,
                       scale=False).reshape(v.shape)
    v = top_stages(v, n, design, done)
    return v * torch.tensor(F.inv_sqrt(n), dtype=torch.float32)


def word_slots(n, bits, design="transpose"):
    """The row's word index that each storing lane of each CTA writes:
    (C, stores)."""
    k = 32 // bits
    _, _, _, a2 = cluster_layouts(n, design)
    first = torch.arange(T) % (k // 4) == 0
    return a2[:, first][:, :, ::4].reshape(n // SEG, -1) // k


def cluster_encode_model(chunks, signs, bits, dither=None, mask=None,
                         rescale=None, residual_dtype=None,
                         design="transpose"):
    """encode_cluster_kernel on each row: each CTA loads its segment in
    layout A × signs, the FWHT (segment stages, top stages, the multiply),
    the row maximum as the maximum of the CTAs' maxima (exact in any
    order), the exchange to layout A2, the dither, each lane's codes at
    their bit offsets, the OR-shuffle tree over the k/4 lanes of a word,
    the mask, the store; for the residual each CTA's decode of its own
    segment's codes from the row's words, the same FWHT and u − y in
    layout X."""
    rows, n = chunks.shape
    c = n // SEG
    pa, _, px, pa2 = cluster_layouts(n, design)
    a, b = row_layouts(SEG)
    tid = torch.arange(T)
    k = 32 // bits
    v = cluster_fwht_model(chunks[:, pa] * signs[pa], n, design)
    scale = v.abs().amax((2, 3)).amax(1)[:, None, None, None]
    v = _exchange(v.reshape(rows * c, T, ROW_V), b, a, SEG).reshape(v.shape)
    if dither is not None:
        v = v + dither[:, pa2] * scale
    code = quantize_code(v, torch.clamp_min(scale, TINY), bits)
    shift = ((4 * tid) % k * bits)[:, None] + (torch.arange(ROW_V) & 3) * bits
    fields = (code << shift).reshape(rows, c, T, 8, 4)
    w = fields[..., 0] | fields[..., 1] | fields[..., 2] | fields[..., 3]
    o = 1
    while o < k // 4:                     # the OR-shuffle tree
        w = w | w[:, :, tid ^ o]
        o <<= 1
    mk = (torch.ones(rows, 1, 1, 1) if mask is None
          else mask.reshape(rows, 1, 1, 1))
    s_out = scale * mk if mask is not None else scale
    if mask is not None:
        w = w * mk.to(torch.int64)        # the int32 product, wrapping
    first = tid % (k // 4) == 0
    raw = torch.full((rows, n // k), -1, dtype=torch.int64)
    raw[:, word_slots(n, bits, design).reshape(-1)] = w[:, :, first].reshape(
        rows, -1)
    words = tref.to_int32(raw & 0xFFFFFFFF)
    if residual_dtype is None:
        return words, s_out.reshape(rows, 1)
    # each lane's codes of its own segment, from the row's words
    idx = (raw[:, pa // k] >> (pa % k * bits)) & (2 ** bits - 1)
    xh = (-1.0 + (2.0 * idx.to(torch.float32) + 1.0) * 2.0 ** -bits) * s_out
    if mask is not None:
        xh = xh * mk
        if rescale is not None:
            xh = xh / torch.tensor(rescale, dtype=torch.float32)
    y = cluster_fwht_model(xh, n, design) * signs[px]
    y = y.to(residual_dtype).to(torch.float32)
    resid = torch.empty_like(chunks)
    resid[:, px] = chunks[:, px] - y
    return words, s_out.reshape(rows, 1), resid


def test_encode_path_route_edges():
    """The route follows from N alone: "row" up to 2^15, "cluster" from
    2^16 to CLUSTER_MAX_N = 2^17 (a cluster of at most 8 CTAs of 2^14, the
    portable cluster size), "passes" above."""
    assert CLUSTER_MAX_N == 1 << 17
    assert encode_path(8192) == "fused"
    assert encode_path(1 << 15) == "row"
    assert encode_path(1 << 16) == encode_path(CLUSTER_MAX_N) == "cluster"
    assert encode_path(2 * CLUSTER_MAX_N) == "passes"
    assert (CLUSTER_MAX_N // SEG) <= 8
    for bad in ((1 << 16) + 32, 3 << 15):
        with pytest.raises(ValueError, match="power-of-2"):
            encode_path(bad)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("log2n", [16, 17])
def test_cluster_stages_keep_the_order(log2n, design, one_thread):
    """Each layout holds every position of the row once; the stages run
    position bits 0..log2 N − 1 once each in increasing order (ref.fwht's):
    14 in the segment, then the top ones; the FWHT bitwise ref.fwht in
    both designs; the transposing exchange reads, in each warp, 128
    consecutive bytes of one CTA's buffer."""
    n = 1 << log2n
    for lay in cluster_layouts(n, design):
        assert torch.equal(lay.reshape(-1).sort().values, torch.arange(n))
    done = []
    cluster_fwht_model(torch.zeros(1, n // SEG, T, ROW_V), n, design, done)
    assert done == [1 << q for q in range(log2n)]
    x = torch.from_numpy(np.random.default_rng(log2n).standard_normal(
        (2, n)).astype(np.float32))
    pa, _, px, _ = cluster_layouts(n, design)
    got = torch.empty_like(x)
    got[:, px] = cluster_fwht_model(x[:, pa], n, design)
    np.testing.assert_array_equal(_bits(got), _bits(tref.fwht(x)))
    if design == "transpose":
        # register s·I + i of thread t reads buffer index t + T·(r·I + i):
        # a warp's 32 threads read 32 consecutive floats
        src = torch.arange(T)[:, None] + T * (torch.arange(ROW_V) % (
            ROW_V * SEG // n))[None]
        warps = src.reshape(-1, 32, ROW_V)
        assert torch.equal(warps - warps[:, :1], torch.arange(32)[None, :,
                                                                  None]
                           .expand_as(warps))


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("log2n", [16, 17])
def test_cluster_ctas_pack_into_their_own_words(log2n, bits, design):
    """Every word is written once, by the CTA that holds all its codes: CTA
    r's words are those of its pieces (transpose: [(s·2^14 + r·P)·R/32,
    (s·2^14 + (r+1)·P)·R/32) for every segment s; pairwise: its segment's
    [r·2^14·R/32, (r+1)·2^14·R/32)), so no word spans two CTAs."""
    n = 1 << log2n
    c, k = n // SEG, 32 // bits
    slots = word_slots(n, bits, design)
    assert torch.equal(slots.reshape(-1).sort().values, torch.arange(n // k))
    p = SEG // c if design == "transpose" else SEG
    for r in range(c):
        starts = ([s * SEG + r * p for s in range(c)]
                  if design == "transpose" else [r * SEG])
        want = torch.cat([torch.arange(st // k, (st + p) // k)
                          for st in starts])
        assert torch.equal(slots[r].sort().values, want)


@functools.cache
def _reference(log2n, bits):
    """The inputs of (log2n, bits) and the reference's encode_ef on them in
    every mode, f32 and bf16 residuals: {mode: [(words, scale, residual)
    f32, bf16]}, one program compiled without XLA's fusion pass (rescale
    passed as an argument, or XLA multiplies by its reciprocal), so that
    the four modes share one compile."""
    n = 1 << log2n
    x, signs, dither, mask = _inputs(2, n, bits, log2n * 100 + bits)

    def run(u, s, d, m, rs):
        out = {}
        for mode in MODES:
            dd, mm, r = _mode(mode, d, m)
            out[mode] = [jref.encode_ef(u, s, bits, dither=dd, mask=mm,
                                        rescale=None if r is None else rs,
                                        residual_dtype=dt)
                         for dt in (jnp.float32, jnp.bfloat16)]
        return out

    out = _unfused(run, *map(jnp.asarray, (x, signs, dither, mask)),
                   jnp.float32(0.6))
    return (x, signs, dither, mask), out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("log2n", [16, 17])
def test_cluster_route_model_bitwise_plain_and_jax(log2n, bits, mode,
                                                   one_thread):
    """encode_cluster_kernel's model against ref.encode / ref.encode_ef
    and the reference's encode_ef compiled without XLA's fusion pass (f32
    and bf16 residuals), on 2 rows (the second zero but for a spike in its
    last value, and masked); the pairwise design's model too (f32)."""
    (x, signs, dither, mask), jout = _reference(log2n, bits)
    d, m, rescale = _mode(mode, dither, mask)
    t = [None if v is None else torch.from_numpy(v)
         for v in (x, signs, d, m)]
    tw, ts = tref.encode(t[0], t[1], bits, dither=t[2], mask=t[3])
    # the pairwise design (the variant) gives the same bits
    pw, ps, pr = cluster_encode_model(t[0], t[1], bits, t[2], t[3], rescale,
                                      torch.float32, design="pairwise")
    _, _, tr32 = tref.encode_ef(t[0], t[1], bits, dither=t[2], mask=t[3],
                                rescale=rescale)
    assert torch.equal(pw, tw) and torch.equal(ps.view(torch.int32),
                                               ts.view(torch.int32))
    assert torch.equal(pr.view(torch.int32), tr32.view(torch.int32))
    for tdt, (jw, js, jr) in zip((torch.float32, torch.bfloat16),
                                 jout[mode]):
        _, _, tr = tref.encode_ef(t[0], t[1], bits, dither=t[2], mask=t[3],
                                  rescale=rescale, residual_dtype=tdt)
        mw, ms, mr = cluster_encode_model(t[0], t[1], bits, t[2], t[3],
                                          rescale, tdt)
        for w in (tw, mw):
            np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        for sc in (ts, ms):
            np.testing.assert_array_equal(_bits(sc), _bits(js))
        np.testing.assert_array_equal(_bits(tr), _bits(jr))
        np.testing.assert_array_equal(_bits(mr), _bits(jr))


@pytest.mark.parametrize("dither,keep", [(False, 1.0), (True, 0.5)])
def test_gradcomp_at_chunk_65536_bitwise_jax(dither, keep):
    """encode_leaf_ef and decode_leaf of a 100,000-value leaf (2 chunks of
    65536, the last padded) against repro.dist.gradcomp, and the ledger of
    a two-leaf tree equal to its audit and to the reference's."""
    kw = dict(bits=4, chunk=65536, dithered=dither, keep_fraction=keep,
              exact_keep=True, error_feedback=not dither)
    jc, tc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((250, 400)).astype(np.float32)
    jp, jr = JG.encode_leaf_ef(jnp.asarray(x), 1, jc, 2)
    tp, tr = TG.encode_leaf_ef(torch.from_numpy(x), 1, tc, 2)
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]))
    np.testing.assert_array_equal(_bits(tr), _bits(jr))
    jd = JG.decode_leaf(jp, 1, x.size, x.shape, jnp.float32, jc)
    td = TG.decode_leaf(tp, 1, x.size, x.shape, torch.float32, tc)
    np.testing.assert_array_equal(_bits(td), _bits(jd))
    y = rng.standard_normal(3000).astype(np.float32)
    tree = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    audit = TG.wire_bytes_tree(tree, tc)["payload_bytes"]
    ledger = TG.wire_bytes_payload(TG.compress_tree(tree, tc, 2)[0], tc)
    assert ledger == audit == JG.wire_bytes_tree(
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jc)["payload_bytes"]
