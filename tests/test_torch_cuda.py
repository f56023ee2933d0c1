"""The CUDA kernels of repro_torch vs their plain PyTorch versions, on the
card. Every test here is marked `cuda` and skips without a GPU and nvcc.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them (the repo's conftest imports JAX; skip it there):

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Payloads (words, scale bits), the EF residual in f32 and bf16, the FWHT,
unpack_dequant (also on whole-range words, unaligned, trimmed) and
quantize_pack must be bitwise equal to the plain versions; the KV-cache
decode attention within rtol = atol = 2e-4, the bound the JAX package
holds its Pallas kernel to (exponentials and sums run in another
order). The codecs' paths (RATQ's rung, `ops.rotate`, lane-stacked
encode / encode_ef / decode, sparsify-then-embed's ties) are held bitwise
card against CPU or against the per-lane calls. Two gloo ranks sharing the
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
    with pytest.raises(ValueError, match="8192"):
        ops.fwht(torch.zeros(2, 16384, device=cuda))
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
    """Bitwise, over rows that do not fill a block, scales above and below
    the rows' maxima (so the clip acts) and a zero scale (the tiny guard)."""
    C.check_quantize_pack(n, bits, cuda)
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
