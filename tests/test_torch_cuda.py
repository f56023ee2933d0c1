"""The CUDA kernels of repro_torch vs their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a GPU and nvcc.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them (the repo's conftest imports JAX; skip it there):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Payloads (words, scale bits), the EF residual in f32 and bf16, the FWHT,
unpack_dequant (also on whole-range words, unaligned, trimmed) and
quantize_pack must be bitwise equal to the plain versions, below and above
N = 8192 (the FWHT's and the encoders' row kernels at 2^14 and 2^15,
also over more rows than SMs; the encoders' cluster kernel at 2^16 and
2^17, also over more rows than clusters; the passes beyond, in every fold
mode, and the FWHT's up to one row of 2^28); the KV-cache
decode attention within rtol = atol = 2e-4, the bound the JAX package
holds its Pallas kernel to (exponentials and sums run in another
order). The codecs' paths (RATQ's rung, `ops.rotate`, lane-stacked
encode / encode_ef / decode, sparsify-then-embed's ties) are held bitwise
card against CPU or against the per-lane calls. The captured programs
(`repro_torch.graph`: the serve programs, the train steps, the
federation's programs, the paper's algorithms and the democratic
embedding; `-k graphs`, `-k train_graphs`, `-k core_graphs`) are held
bitwise against `graph.eager()`. Two gloo ranks sharing the
card (this file run as a script is one rank) hold ZeRO-1 against the
all-gather consensus and the mesh federation against the vmap backend,
bitwise."""
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import checks as C


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.CODEC_ROWS)
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("n", C.CODEC_N)
@pytest.mark.parametrize("mode", C.CODEC_MODES)
def test_cuda_kernels_match_plain(cuda, bits, n, mode, rows):
    """encode, encode_ef (f32 and bf16 residuals), unpack_dequant and the
    FWHT bitwise, over rows that leave a warp or a block partly filled, an
    all-zero row and rows whose only value or maximum sits in the last
    lane; in det mode also from unaligned inputs."""
    C.check_codec(n, bits, mode, rows, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.CODEC_ROWS)
@pytest.mark.parametrize("n", C.FWHT_SMALL_N)
def test_cuda_fwht_small_n_matches_plain(cuda, n, rows):
    C.check_fwht(n, rows, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_launch_counts_and_refusals(cuda):
    ops.reset_launch_counts()
    x = torch.randn(4, 64, device=cuda)
    ops.unrotate(ops.fwht(x), torch.ones(64, device=cuda))
    assert ops.launch_counts()["fwht"] == 2
    # above 8192 the row kernel or the passes run (one count per call),
    # non-powers of 2 raise
    assert ops.fwht(torch.zeros(2, 16384, device=cuda)).shape == (2, 16384)
    assert ops.launch_counts()["fwht"] == 3
    with pytest.raises(ValueError, match="power-of-2"):
        ops.fwht(torch.zeros(2, 12288, device=cuda))
    with pytest.raises(ValueError):
        ops.encode(torch.zeros(2, 64, device=cuda, dtype=torch.float64),
                   torch.ones(64, device=cuda), 4)
    words = ops.quantize_pack(x, torch.ones(4, 1, device=cuda), 4)
    assert ops.launch_counts()["quantize_pack"] == 1
    assert words.shape == (4, 8) and words.dtype == torch.int32
    q, kw, ks, vw, vs, kv_len = C.attention_inputs(2, 16, 2, 4, 64, 8, 0,
                                                   cuda)
    ops.quant_decode_attention(q, kw, ks, vw, vs, kv_len, bits=8)
    assert ops.launch_counts()["quant_decode_attention"] == 1
    with pytest.raises(ValueError, match="bits"):
        ops.quantize_pack(x, torch.ones(4, 1, device=cuda), 3)
    with pytest.raises(ValueError, match="bits"):
        ops.quant_decode_attention(q, kw, ks, vw, vs, kv_len, bits=3)
    q96, kw96, ks96, vw96, vs96, len96 = C.attention_inputs(
        2, 16, 2, 4, 96, 8, 0, cuda)
    with pytest.raises(ValueError, match="power of 2"):
        ops.quant_decode_attention(q96, kw96, ks96, vw96, vs96, len96, bits=8)
    assert ops.launch_counts()["quantize_pack"] == 1
    assert ops.launch_counts()["quant_decode_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.CODEC_ROWS)
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("n,full_n", C.UNPACK_SHAPES)
def test_cuda_unpack_dequant_matches_plain(cuda, bits, n, full_n, rows):
    """Bitwise over words drawn from the whole int32 range, aligned and
    unaligned: whole rows at a power-of-two wpr (the flat path); whole rows
    at a non-power-of-two wpr and trimmed rows (the row path); rows that
    leave the last block partly filled."""
    C.check_unpack(bits, n, full_n, rows, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("n", C.PACK_N)
def test_cuda_quantize_pack_matches_plain(cuda, bits, n):
    """Bitwise, over one row, rows that do not fill a block and several
    blocks, scales above and below the rows' maxima (so the clip acts), a
    zero scale (the tiny guard) and a row whose maximum sits in its last
    lane, from aligned and unaligned x: the flat float4 stream, and the row
    kernel at 12288."""
    C.check_quantize_pack(n, bits, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.LARGE_ROWS)
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("n", C.LARGE_N)
@pytest.mark.parametrize("mode", C.CODEC_MODES)
def test_cuda_large_n_kernels_match_plain(cuda, bits, n, mode, rows):
    """Above N = 8192: the FWHT's passes and the encoders (encode,
    encode_ef with f32 and bf16 residuals; the row kernel at 2^14 and
    2^15, the passes at 2^20) bitwise, with the check_codec grid's special
    rows; in det mode also from unaligned inputs."""
    C.check_codec(n, bits, mode, rows, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.LARGE_ROWS)
@pytest.mark.parametrize("n", C.LARGE_N)
def test_cuda_large_n_fwht_matches_plain(cuda, n, rows):
    C.check_fwht(n, rows, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.ROW_ROWS)
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("n", C.ROW_N)
@pytest.mark.parametrize("mode", C.CODEC_MODES)
def test_cuda_large_n_row_encoders_stride_over_rows(cuda, bits, n, mode,
                                                    rows):
    """The encoders' row kernel at more rows than the card has SMs, so
    each persistent block runs several rows with the next one staged:
    encode and encode_ef (f32 and bf16 residuals) bitwise, with the
    check_codec grid's special rows; in det mode also from unaligned
    inputs."""
    C.check_encoders(n, bits, mode, rows, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.LARGE_ROWS + C.ROW_ROWS)
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("n", C.CLUSTER_N)
@pytest.mark.parametrize("mode", C.CODEC_MODES)
def test_cuda_large_n_cluster_route_strides_over_rows(cuda, bits, n, mode,
                                                      rows):
    """The encoders' cluster kernel (a cluster of CTAs a row, the top
    stages through distributed shared memory) on one row, on fewer rows
    than persistent clusters and on more: encode and encode_ef (f32 and
    bf16 residuals) bitwise, with the check_codec grid's special rows,
    from aligned and unaligned inputs in every mode; one launch a call."""
    from repro_torch.kernels.quantencode import encode_path
    assert encode_path(n) == "cluster"
    ops.reset_launch_counts()
    C.check_encoders(n, bits, mode, rows, cuda, unaligned=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["encode"], counts["encode_ef"]) == (2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", C.LARGE_ROWS + C.ROW_ROWS)
@pytest.mark.parametrize("n", C.ROW_N)
def test_cuda_large_n_fwht_row_route_strides_over_rows(cuda, n, rows):
    """The FWHT's row kernel (one launch at 2^14 and 2^15) on one row,
    on fewer rows than persistent blocks and on more, so that each block
    strides over rows with the next one staged; aligned and unaligned
    input, bitwise."""
    from repro_torch.kernels import fwht as F
    assert F.fwht_path(n) == "row"
    C.check_fwht(n, rows, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n", C.FWHT_HUGE_N)
def test_cuda_fwht_of_a_dsc_frame_matches_plain(cuda, n):
    """One row of 2^23, 2^26 and 2^28 (1 GiB), aligned and unaligned: the
    dsc codec's frames on a full-width yi-6b."""
    C.check_fwht(n, 1, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("dh", C.ATTN_DH)
@pytest.mark.parametrize("c", C.ATTN_C)
@pytest.mark.parametrize("g", C.ATTN_G)
def test_cuda_quant_decode_attention_matches_plain(cuda, bits, dh, c, g):
    """kv_len per batch row: 0 (uniform mean over all C), 1, C and a
    ragged length; C not a multiple of the tile."""
    C.check_quant_decode_attention(bits, dh, c, g, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bits", C.BITS)
@pytest.mark.parametrize("dh,g", C.ATTN_FAMILY_SHAPES)
@pytest.mark.parametrize("c", C.ATTN_C)
def test_cuda_quant_decode_attention_family_groups_match_plain(cuda, bits,
                                                               dh, g, c):
    """The group sizes hymba (G 5, dh 64) and mixtral (G 6, dh 128) serve
    at: G not a power of two, on the warp-resident kernel."""
    C.check_quant_decode_attention(bits, dh, c, g, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("bits,dh,g", [
    (bits, dh, g) for bits in C.BITS for dh, g in C.ATTN_TILE_SHAPES
    if dh * bits % 32 == 0])
@pytest.mark.parametrize("c", C.ATTN_TILE_C)
def test_cuda_quant_decode_attention_tile_path_matches_plain(cuda, bits, dh,
                                                             g, c):
    """The shapes the shared-memory tile kernel takes (dh < 32, G > 8,
    dh > 256), split and combined like the warp-resident kernel's."""
    C.check_quant_decode_attention(bits, dh, c, g, cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,N", [(30, 32), (116, 128), (1000, 1024),
                                 (8192, 8192), (5000, 8192)])
def test_cuda_hadamard_frame_matches_cpu(cuda, n, N):
    """A Hadamard frame drawn from a key on the card has the CPU's signs
    and rows, and its S x and Sᵀ y (the FWHT kernel plus a gather or a
    scatter) are bitwise the CPU's plain versions."""
    from repro_torch import random as rnd
    from repro_torch.core import frames as F
    host = F.hadamard_frame(rnd.key(n), n, N)
    card = F.hadamard_frame(rnd.key(n, device=cuda), n, N)
    assert torch.equal(card.signs.cpu(), host.signs)
    assert torch.equal(card.rows.cpu(), host.rows)
    g = torch.Generator().manual_seed(N)
    x, y = torch.randn(3, N, generator=g), torch.randn(3, n, generator=g)
    ops.reset_launch_counts()
    assert torch.equal(card.apply(x.to(cuda)).cpu(), host.apply(x))
    assert torch.equal(card.apply_t(y.to(cuda)).cpu(), host.apply_t(y))
    assert ops.launch_counts()["fwht"] == 2


@pytest.mark.cuda
def test_cuda_draws_match_cpu(cuda):
    """permutation (one and two sorting rounds), randint and uniform under
    a stack of keys: the card's draws are the CPU's, bit for bit."""
    from repro_torch import random as rnd
    for n in (116, 1625, 1626, 8192):
        assert torch.equal(rnd.permutation(rnd.key(3, device=cuda), n).cpu(),
                           rnd.permutation(rnd.key(3), n))
    for lo, hi in ((0, 10), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1)):
        assert torch.equal(
            rnd.randint(rnd.key(5, device=cuda), (64, 7), lo, hi).cpu(),
            rnd.randint(rnd.key(5), (64, 7), lo, hi))
    keys = rnd.split(rnd.key(6), 10)
    assert torch.equal(rnd.uniform(keys.to(cuda), (10, 33)).cpu(),
                       rnd.uniform(keys, (10, 33)))


def _codec_tree(seed, dev):
    """A small parameter tree: sizes not multiples of the chunk, one leaf
    under a chunk."""
    g = torch.Generator().manual_seed(seed)
    return {"w": (torch.randn(37, 19, generator=g) ** 3).to(dev),
            "s": torch.randn(5, generator=g).to(dev),
            "v": torch.randn(3, 5, 7, generator=g).to(dev)}


def _same(a, b):
    from repro_torch import tree as tree_lib
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


@pytest.mark.cuda
def test_cuda_ratq_rung_matches_cpu(cuda):
    """RATQ's rung on the card over the sweep of every f32 within 64 ulps
    of each power of two from 2^-15 to 1 and 10^5 uniform draws: the CPU
    port's rung (itself held to the reference's), bit for bit."""
    from repro_torch.codecs import stages
    x = C.ratq_rung_sweep(16)
    assert torch.equal(stages.ratq_rung(x.to(cuda), 16).cpu(),
                       stages.ratq_rung(x, 16))


@pytest.mark.cuda
def test_cuda_rotate_matches_plain(cuda):
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(0)
    chunks = torch.randn(37, 256, generator=g)
    signs = torch.where(torch.rand(256, generator=g) < 0.5, -1.0, 1.0)
    ops.reset_launch_counts()
    got = ops.rotate(chunks.to(cuda), signs.to(cuda))
    assert ops.launch_counts()["fwht"] == 1
    assert torch.equal(got.cpu(), ref.fwht(chunks * signs))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 7, 512])
@pytest.mark.parametrize("name,budget,kw", [
    ("ndsc", 2.0, dict(chunk=32)),
    ("ndsc", 0.5, dict(chunk=64, dithered=True)),
    ("ratq", 1.0, dict(chunk=32)),
    ("ratq", 4.0, dict(chunk=64))])
def test_cuda_lane_stacked_codecs_match_per_lane(cuda, lanes, name, budget,
                                                 kw):
    """encode, encode_ef and decode over L lanes on the card (one kernel
    launch per leaf), bitwise the per-lane calls on the card."""
    from repro_torch import codecs
    from repro_torch import random as rnd
    from repro_torch.codecs import base
    c = codecs.make(name, budget, **kw)
    trees = [_codec_tree(s, cuda) for s in range(lanes)]
    stacked = base.stack(trees)
    keys = rnd.split(rnd.key(3, device=cuda), lanes)
    meta = c.meta(trees[0])
    ops.reset_launch_counts()
    wire = base.encode_lanes(c, keys, stacked, 2)
    dec = base.decode_lanes(c, wire, meta, lanes)
    counts = ops.launch_counts()
    assert counts["unpack_dequant"] == 3
    assert counts["encode" if name == "ndsc" else "quantize_pack"] == 3
    resid = None
    if c.encode_ef is not None:
        wire2, resid = base.encode_ef_lanes(c, keys, stacked, meta, 2)
        _same(wire, wire2)
    for i in range(lanes):
        one = c.encode(keys[i], trees[i], 2)
        _same(one, base.lane(wire, i))
        _same(c.decode(one, meta), base.lane(dec, i))
        if resid is not None:
            _same(c.encode_ef(keys[i], trees[i], meta, 2)[1],
                  base.lane(resid, i))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["topk", "randk"])
def test_cuda_sparsify_then_embed_matches_cpu(cuda, mode):
    """A leaf of repeated magnitudes (ties at the top-k threshold): the
    card's survivors, words and scales are the CPU's, bit for bit."""
    from repro_torch import codecs
    from repro_torch import random as rnd
    x = torch.tensor([1.0, -3.0, 2.0, 3.0, -2.0, 3.0, 1.0, -1.0] * 1000)
    c = codecs.make("sparsify_then_embed", 1.0, mode=mode, chunk=64)
    host = c.encode(rnd.key(4), {"x": x}, 1)
    card = c.encode(rnd.key(4, device=cuda), {"x": x.to(cuda)}, 1)
    _same(host, card)
    meta = c.meta({"x": x})
    _same(c.decode(host, meta), c.decode(card, meta))


# ---------------------------------------------------------------------------
# Captured serve programs (repro_torch.graph): CUDA graphs against eager
# ---------------------------------------------------------------------------
def _serve_programs_run(cfg, params, dev):
    """The engine's programs on a fresh 2-slot state: two cold admissions
    of one length (the second replays with another slot), 4 decode steps,
    two prefix admissions of one entry and length, 4 more steps. Returns
    (every logits tensor, the final caches and positions, the launches)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import decode as D
    from repro_torch.serve import engine as E

    E._programs.cache_clear()
    step, _, _, admit_cold, admit_prefix = E._programs(cfg, 40)
    st = D.init_decode_state(cfg, 2, 40, device=dev)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g,
                             dtype=torch.int32).to(dev) for n in (6, 6, 3, 3)]
    before = kops.launch_counts()
    logits = []

    def decode(st, steps):
        tok = torch.stack([x.argmax() for x in logits[-2:]]).to(
            torch.int32)[:, None]
        for _ in range(steps):
            lg, st = step(params, st, tok)
            logits.append(lg)
            tok = D.greedy_token(lg)
        return st

    for slot in (0, 1):
        st, lg = admit_cold(params, st, prompts[slot], slot)
        logits.append(lg)
    st = decode(st, 4)
    entry = D.extract_slot(st, 1)
    for slot in (0, 1):
        st, lg = admit_prefix(params, st, entry, prompts[2 + slot], slot)
        logits.append(lg)
    st = decode(st, 4)
    torch.cuda.synchronize()
    after = kops.launch_counts()
    return ([x.cpu() for x in logits],
            {k: v.cpu() for k, v in st.caches.items()}, st.pos.cpu(),
            {k: after[k] - before[k] for k in after})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b"])
def test_cuda_graphs_match_the_eager_arm(cuda, arch):
    """The reduced yi-6b and hymba through the 8-bit cache: the captured
    programs give the eager arm's logits, cache words and positions
    bitwise, and the same kernel launch counts."""
    import dataclasses
    from repro_torch import configs, graph
    from repro_torch.models import model

    cfg = dataclasses.replace(configs.get_reduced(arch), kv_quant_bits=8)
    params = model.init_params(0, cfg, cuda)
    got = _serve_programs_run(cfg, params, cuda)
    with graph.eager():
        want = _serve_programs_run(cfg, params, cuda)
    assert len(got[0]) == len(want[0]) == 12
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for name, x in want[1].items():
        assert torch.equal(got[1][name].view(torch.uint8),
                           x.view(torch.uint8)), name
    assert torch.equal(got[2], want[2])
    assert got[3] == want[3] and got[3]["quant_decode_attention"] > 0


# ---------------------------------------------------------------------------
# Captured training programs (repro_torch.graph): CUDA graphs against eager
# ---------------------------------------------------------------------------
TRAIN_KINDS = {"allgather_ef": {},
               "dithered_keep": {"dithered": True, "error_feedback": False,
                                 "keep_fraction": 0.5},
               "zero1": {"strategy": "alltoall_zero1"}}


def _bits_equal(a, b) -> bool:
    from repro_torch import tree as tree_lib
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _train_programs_run(kind: str, dev):
    """3 steps of the reduced yi-6b's train step (AdamW, clip 1) from the
    seeded state, on tokens drawn on the CPU: ((state, metrics), the
    kernel launches, the step program's specializations)."""
    from repro_torch import configs
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import step as S
    from repro_torch.optimizer import optim

    cfg = configs.get_reduced("yi-6b")
    gc = G.GradCompConfig(**TRAIN_KINDS[kind])
    opt = optim.adamw(optim.warmup_cosine(3e-4, 1, 10), weight_decay=0.1)
    make, init = ((S.make_zero_train_step, S.init_zero_state)
                  if kind == "zero1" else
                  (S.make_train_step, S.init_train_state))
    step = make(cfg, opt, gc, clip_norm=1.0)
    state = init(cfg, opt, gc, device=dev)
    g = torch.Generator().manual_seed(2)
    before = ops.launch_counts()
    metrics = []
    for _ in range(3):
        toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=g,
                             dtype=torch.int32).to(dev)
        *state, m = step(*state, {"tokens": toks})
        metrics.append(m)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    return ((state, metrics), {k: after[k] - before[k] for k in after},
            step.program._cache_size())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(TRAIN_KINDS))
def test_cuda_train_graphs_match_the_eager_arm(cuda, kind):
    """The captured train step (one specialization for the 3 steps) gives
    the eager arm's losses, grad norms, params, optimizer state and EF
    bitwise, with the same kernel launches (one per leaf and kernel a
    step, replays counted)."""
    from repro_torch import graph
    got, launches, specs = _train_programs_run(kind, cuda)
    with graph.eager():
        want, launches_eager, _ = _train_programs_run(kind, cuda)
    assert specs == 1
    assert _bits_equal(got, want)
    assert launches == launches_eager and max(launches.values()) > 0


def _fed_programs_run(dev):
    """A 6-client federation (two cohorts and singletons, fedmem, 50%
    participation, local mini-batches) for 4 rounds: (history, server,
    client states, launches)."""
    from repro_torch import codecs, fed

    g = torch.Generator().manual_seed(3)
    shards = [{"a": torch.randn(32, 16, generator=g),
               "b": torch.randn(32, generator=g)} for _ in range(6)]

    def loss(p, batch):
        r = batch["a"] @ p["x"] - batch["b"]
        return 0.5 * torch.mean(r * r)

    f = fed.Federation(
        loss, {"x": torch.zeros(16)}, shards,
        [codecs.make("ndsc", r, chunk=32) for r in (1, 1, 1, 2, 2, 4)],
        fed.ClientConfig(lr=0.1, local_steps=2, batch_size=8),
        fed.ServerConfig(aggregator="fedmem", server_lr=0.5), seed=0,
        device=dev)
    before = ops.launch_counts()
    hist = f.run(fed.FedConfig(num_rounds=4, participation=0.5, seed=0))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    return hist, f.server, f.states, {k: after[k] - before[k] for k in after}


@pytest.mark.cuda
def test_cuda_train_graphs_federation_matches_the_eager_arm(cuda):
    """The federation's captured programs (client rounds, decodes, the
    fedmem aggregate) give the eager arm's ledger, participants, params
    and client states bitwise, with the same kernel launches."""
    from repro_torch import graph
    hist, server, states, launches = _fed_programs_run(cuda)
    with graph.eager():
        hist_e, server_e, states_e, launches_e = _fed_programs_run(cuda)
    assert hist == hist_e
    assert _bits_equal(server, server_e) and _bits_equal(states, states_e)
    assert launches == launches_e and launches["encode_ef"] > 0


# ---------------------------------------------------------------------------
# Captured core programs (the paper's algorithms, the democratic embedding)
# ---------------------------------------------------------------------------
def _core_cases():
    from repro_torch.core import checks
    return sorted(checks.CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("draw_block", [None, 64])
@pytest.mark.parametrize("case", _core_cases())
def test_cuda_core_graphs_match_the_eager_arm(cuda, case, draw_block,
                                              monkeypatch):
    """Each algorithm's step, captured once and replayed for 20 steps,
    gives the eager arm's x_final, x_avg and dist_history bitwise, with
    the same kernel launches. With a draw block of 64 values every draw
    crosses block boundaries, refilled in place between replays."""
    import contextlib
    from repro_torch import graph
    from repro_torch import random as R
    from repro_torch.core import checks
    if draw_block is not None:
        monkeypatch.setattr(R, "_DRAW_BLOCK", draw_block)
    runs = []
    with checks.recorded_programs() as made:
        for eager in (False, True):
            before = ops.launch_counts()
            with graph.eager() if eager else contextlib.nullcontext():
                trace = checks.run(case, cuda, steps=20)
            torch.cuda.synchronize()
            after = ops.launch_counts()
            runs.append((trace, {k: after[k] - before[k] for k in after}))
    (got, launches), (want, launches_eager) = runs
    steps = [p for p in made if p.fn.__name__ == "step"]
    assert len(steps) == 2 and len(steps[0].capture_s) == 1
    assert not steps[1].capture_s
    assert all(_bits_equal(x, y) for x, y in zip(got, want))
    assert launches == launches_eager
    assert torch.isfinite(got.dist_history).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["hadamard", "haar"])
def test_cuda_core_graphs_democratic_matches_eager(cuda, kind):
    """Top-level democratic captured (one capture, then a replay on new
    inputs) against graph.eager(), bitwise."""
    from repro_torch import graph
    from repro_torch.core import checks
    from repro_torch.core import embeddings as E
    frame, y = checks.democratic_case(kind, cuda)
    captures = len(E._DEMOCRATIC.capture_s)
    got = [E.democratic(frame, y), E.democratic(frame, y * 2.0)]
    with graph.eager():
        want = [E.democratic(frame, y), E.democratic(frame, y * 2.0)]
    torch.cuda.synchronize()
    assert len(E._DEMOCRATIC.capture_s) == captures + 1
    assert all(_bits_equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# Two gloo ranks sharing the card (repro_torch.dist, repro_torch.fed.mesh)
# ---------------------------------------------------------------------------
def _rank_two_workers(rank: int, world: int, init: str, out_dir: str):
    """One rank of `test_cuda_two_ranks_share_the_card` (this file run as a
    script): ZeRO-1 against all-gather after one step, and a mesh
    federation against the vmap backend, on the card."""
    import os
    import numpy as np
    from repro_torch import codecs, fed
    from repro_torch import tree as tree_lib
    from repro_torch.dist import gradcomp as G
    from repro_torch.dist import sharding, step, zero
    from repro_torch.launch import mesh
    from repro_torch.models import model
    from repro_torch.optimizer import optim

    torch.set_num_threads(1)
    group, dev = mesh.init_workers(rank, world, init, device="cuda")
    out = {"backend": torch.distributed.get_backend(group)}
    cfg = model.ModelConfig(name="tiny", num_layers=1, d_model=36,
                            num_heads=2, num_kv_heads=1, d_ff=70,
                            vocab_size=50, vocab_pad_multiple=16)

    def loss(p, b):
        return sum(torch.sum(x * y[0]) for x, y in zip(tree_lib.leaves(p),
                                                       tree_lib.leaves(b)))

    g = torch.Generator().manual_seed(5)
    batch = tree_lib.map(lambda x: torch.randn((world,) + tuple(x.shape),
                                               generator=g).to(dev),
                         model.init_params(0, cfg, "cpu"))
    opt = optim.sgd(1.0)
    gc = G.GradCompConfig(bits=4, chunk=64)
    st = step.init_train_state(cfg, opt, gc, group, seed=0, device=dev)
    params = step.make_train_step(cfg, opt, gc, group, loss_fn=loss)(
        *st, batch)[0]
    gz = G.GradCompConfig(bits=4, chunk=64, strategy="alltoall_zero1")
    zs = step.init_zero_state(cfg, opt, gz, group, seed=0, device=dev)
    owned = step.make_zero_train_step(cfg, opt, gz, group, loss_fn=loss)(
        *zs, batch)[0]
    same = True
    for p, o in zip(tree_lib.leaves(params), tree_lib.leaves(owned)):
        full = sharding.all_gather_stack(o, group).reshape(-1, gc.chunk)
        same &= torch.equal(zero.from_owned(full, p.numel(), p.shape,
                                            p.dtype), p)
    out["zero_eq_allgather"] = same

    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 32, 48)).astype(np.float32)
    shards = [{"a": torch.from_numpy(a[i]),
               "b": torch.from_numpy(a[i].sum(1))} for i in range(5)]
    cs = ([codecs.make("ndsc", 2.0, chunk=32)] * 3
          + [codecs.make("ndsc", 0.5, chunk=32)] * 2)
    runs = []
    for backend in ("vmap", "mesh"):
        f = fed.Federation(
            lambda p, b: 0.5 * torch.mean((b["a"] @ p["x"] - b["b"]) ** 2),
            {"x": torch.zeros(48)}, shards, cs, fed.ClientConfig(lr=0.1),
            seed=1, backend=backend,
            group=group if backend == "mesh" else None, device=dev)
        runs.append((f, f.run(fed.FedConfig(num_rounds=3))))
    (fv, hv), (fm, hm) = runs
    out["mesh_eq_vmap"] = hv == hm and all(
        torch.equal(x, y) for x, y in zip(
            tree_lib.leaves((fv.server, fv.states)),
            tree_lib.leaves((fm.server, fm.states))))
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


@pytest.mark.cuda
def test_cuda_two_ranks_share_the_card(cuda, tmp_path):
    """Two ranks on one card take gloo (NCCL cannot put two ranks of one
    communicator on a card): ZeRO-1 equals all-gather after one step, and
    the mesh federation equals the vmap backend, bitwise."""
    import numpy as np
    from repro_torch.launch import mesh
    res = mesh.run_local_ranks(
        lambda r, init: [__file__, str(r), "2", init, str(tmp_path)], 2,
        300.0)
    for r, (rc, _, err) in enumerate(res):
        assert rc == 0, f"rank {r}:\n{err[-3000:]}"
    for r in range(2):
        f = np.load(tmp_path / f"rank{r}.npz")
        assert str(f["backend"]) == "gloo"
        assert bool(f["zero_eq_allgather"]) and bool(f["mesh_eq_vmap"])


if __name__ == "__main__":
    import sys
    _rank_two_workers(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                      sys.argv[4])
