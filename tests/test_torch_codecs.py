"""repro_torch.codecs vs repro.codecs on the CPU, eager, same numpy inputs
and keys.

Contract: every wire codec's payload (words, scales, masks, rung indices,
gains, top-k / rand-k indices, dsc codewords) is bitwise equal to the
reference's under the same key and round; decodes and ndsc's EF residual
bitwise (the port repeats the eager reference op for op); the realized
ledger equals the analytic audit to the byte, and both equal the
reference's. Simulation baselines are held as `test_torch_core.py` holds
`core.baselines`: bitwise where the scale is a max, within 1e-6 relative
to ‖y‖∞ where it is a sum. RATQ at R < 1 is gated on its payload, not on
the error bound the reference itself misses (ROADMAP queue 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codecs as jcodecs
from repro_torch import codecs as tcodecs
from repro_torch import random as R
from repro_torch import tree as tree_lib
from repro_torch.codecs import base as tbase
from repro_torch.codecs import stages as tstages
from repro_torch.kernels import checks

CHUNK = 32


def _kd(k):
    return torch.from_numpy(
        np.asarray(jax.random.key_data(k)).astype(np.int64))


def _same_bits(want, got: torch.Tensor):
    want = np.ascontiguousarray(np.asarray(want))
    got = np.ascontiguousarray(got.numpy())
    assert want.shape == got.shape and want.dtype == got.dtype, (
        want.shape, got.shape, want.dtype, got.dtype)
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


def _same_tree(want, got):
    wl, gl = jax.tree.leaves(want), tree_lib.leaves(got)
    assert len(wl) == len(gl)
    for a, b in zip(wl, gl):
        _same_bits(a, b)


def _tree(seed=0):
    """Sizes not multiples of the chunk, one leaf under a chunk, nesting."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((37, 19)) ** 3).astype(np.float32),
            "s": rng.standard_normal(5).astype(np.float32),
            "nested": {"v": rng.standard_normal((3, 5, 7)).astype(
                np.float32)}}


def _both(t):
    return (jax.tree.map(jnp.asarray, t),
            tree_lib.map(torch.from_numpy, t))


def _pair(name, budget, **kw):
    return jcodecs.make(name, budget, **kw), tcodecs.make(name, budget, **kw)


WIRE_CASES = (
    [("ndsc", r, dict(chunk=CHUNK, dithered=d))
     for r in (0.5, 1.0, 1.5, 2.0, 4.0, 8.0) for d in (False, True)]
    + [("ndsc", [0.5, 2.0, 8.0], dict(chunk=CHUNK)),
       ("ndsc", [1.5, 0.25, 4.0], dict(chunk=CHUNK, dithered=True))]
    + [("ratq", r, dict(chunk=CHUNK)) for r in (0.5, 1.0, 2.0)]
    + [("sparsify_then_embed", 1.0, dict(mode=m, chunk=CHUNK, dithered=d))
       for m in ("topk", "randk") for d in (False, True)]
    + [("dsc", r, dict(dithered=d)) for r in (0.5, 2.0) for d in (False, True)]
    + [("identity", 32.0, {})])


def _case_id(case):
    name, budget, kw = case
    return f"{name}-{budget}-" + "-".join(f"{k}{v}" for k, v in kw.items())


@pytest.mark.parametrize("case", WIRE_CASES, ids=_case_id)
def test_wire_decode_and_ledger_bitwise(case):
    name, budget, kw = case
    jc, tc = _pair(name, budget, **kw)
    jt, tt = _both(_tree())
    k = jax.random.key(7)
    jw = jc.encode(k, jt, 3)
    tw = tc.encode(_kd(k), tt, 3)
    _same_tree(jw, tw)
    jm, tm = jc.meta(jt), tc.meta(tt)
    _same_tree(jc.decode(jw, jm), tc.decode(tw, tm))
    assert tc.wire_bits(tt) == jc.wire_bits(jt)
    assert tc.wire_bytes(tw, tm) == jc.wire_bytes(jw, jm)
    if not (name == "dsc" and budget < 1.0):
        # dsc below 1 bit per embedded dim keeps a Bernoulli subset: its
        # audit is the expected count, its ledger the realized one (equal
        # to the reference's above); every other wire has a fixed size
        assert tc.wire_bytes(tw, tm) == tc.wire_bits(tt) / 8
    assert (tc.name, tc.rate, tc.spec) == (jc.name, jc.rate, jc.spec)
    assert (tc.encode_ef is None) == (jc.encode_ef is None)
    if tc.encode_ef is not None:
        jw2, jr = jc.encode_ef(k, jt, jm, 3)
        tw2, tr = tc.encode_ef(_kd(k), tt, tm, 3)
        _same_tree(jw2, tw2)
        _same_tree(jw, tw2)                     # the same wire as encode
        _same_tree(jr, tr)


def test_topk_ties_keep_the_lower_index():
    """A leaf of repeated magnitudes: jax.lax.top_k keeps the lower index
    among equals, and so does the port."""
    x = np.array([1.0, -3.0, 2.0, 3.0, -2.0, 3.0, 1.0, -1.0] * 9,
                 np.float32)
    jc, tc = _pair("sparsify_then_embed", 1.0, mode="topk", chunk=CHUNK)
    jw = jc.encode(jax.random.key(0), {"x": jnp.asarray(x)})
    tw = tc.encode(R.key(0), {"x": torch.from_numpy(x)})
    _same_tree(jw, tw)
    a = torch.from_numpy(np.abs(x))
    _same_bits(jax.lax.top_k(jnp.abs(jnp.asarray(x)), 20)[1],
               tstages.top_indices(a, 20).to(torch.int32))


@pytest.mark.parametrize("name,budget", [("sign", 1.0), ("ternary", 1.5),
                                         ("qsgd", 4.0), ("naive", 3.0),
                                         ("dither", 2.0), ("topk", 4.0),
                                         ("randk", 4.0)])
def test_simulation_baselines(name, budget):
    jc, tc = _pair(name, budget)
    jt, tt = _both(_tree(1))
    k = jax.random.key(2)
    jw, tw = jc.encode(k, jt, 5), tc.encode(_kd(k), tt, 5)
    for a, b in zip(jax.tree.leaves(jw), tree_lib.leaves(tw)):
        if name in ("qsgd", "sign"):        # ℓ2 / ℓ1 scales: sums
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6 * np.abs(a).max())
        else:
            _same_bits(a, b)
    jm, tm = jc.meta(jt), tc.meta(tt)
    assert tc.sim_only and jc.sim_only
    assert tc.wire_bits(tt) == jc.wire_bits(jt)
    assert tc.wire_bytes(tw, tm) == jc.wire_bytes(jw, jm)
    assert [tuple(x.shape) for x in tree_lib.leaves(tc.decode(tw, tm))] == [
        tuple(x.shape) for x in jax.tree.leaves(jc.decode(jw, jm))]


def test_codec_specs_match_the_reference():
    assert tcodecs.available() == jcodecs.available()
    for name in tcodecs.available():
        jc, tc = jcodecs.make(name), tcodecs.make(name)
        assert tc.spec == jc.spec, name
        assert tcodecs.make(tc.spec).spec == tc.spec
        assert tc.name == jc.name
    for kw in (dict(chunk=64), dict(chunk=128, seed=0)):
        assert (tcodecs.codec_spec("ndsc", 1.5, kw)
                == jcodecs.codec_spec("ndsc", 1.5, kw))
    assert (tcodecs.make("ndsc", [1.0, 2.0]).spec
            == jcodecs.make("ndsc", [1.0, 2.0]).spec)
    assert tcodecs.make(tcodecs.make("ndsc", [1.0, 2.0]).spec).spec == (
        "ndsc", (1.0, 2.0), tcodecs.make("ndsc", [1.0, 2.0]).spec[2])
    for b in (0.25, 1.0, 1.5, 3.0, 8.0):
        assert (tcodecs.gradcomp_config_for_budget(b, 64).effective_bits
                == jcodecs.gradcomp_config_for_budget(b, 64).effective_bits)


def test_registry_errors():
    with pytest.raises(ValueError, match="did you mean 'ndsc'"):
        tcodecs.make("ndcs", 1.0)
    with pytest.raises(ValueError, match="available: dither, dsc"):
        tcodecs.make("zzz", 1.0)
    with pytest.raises(ValueError, match="malformed codec spec"):
        tcodecs.make(("ndsc", 1.0))
    with pytest.raises(ValueError, match="no extra arguments"):
        tcodecs.make(tcodecs.make("ndsc", 1.0).spec, 2.0)
    with pytest.raises(ValueError, match="did you mean"):
        tcodecs.codec_spec("ratqq", 1.0, {})
    with pytest.raises(ValueError, match="scalar"):
        tcodecs.make("ratq", [1.0, 2.0])
    with pytest.raises(ValueError, match=r"\(0, 8\]"):
        tcodecs.make("ndsc", 9.0)
    with pytest.raises(ValueError, match="mode"):
        tcodecs.make("sparsify_then_embed", 1.0, mode="bottomk")
    with pytest.raises(TypeError):
        tcodecs.make("ndsc", 1.0, chunks=64)
    for bad in (lambda: tcodecs.Transform("dct"),
                lambda: tcodecs.Sparsify("drop"),
                lambda: tcodecs.Sparsify("chunk_drop", fraction=0.0),
                lambda: tcodecs.Quantize("uniform", bits=3),
                lambda: tcodecs.Quantize("ratq", ladder=1),
                lambda: tcodecs.Pack("int8"),
                lambda: tcodecs.Pipeline(transform=tcodecs.Transform(
                    "identity")).leaf(),
                lambda: tcodecs.Pipeline(sparsify=tcodecs.Sparsify(
                    "topk", 0.5), quantize=tcodecs.Quantize("ratq")).leaf()):
        with pytest.raises(ValueError):
            bad()
    c = tcodecs.make("ndsc", [1.0, 2.0])
    with pytest.raises(ValueError, match="per-leaf pipelines"):
        c.meta({"a": torch.zeros(3)})


LANE_CASES = [("ndsc", 2.0, dict(chunk=CHUNK)),
              ("ndsc", 0.5, dict(chunk=CHUNK, dithered=True)),
              ("ndsc", 1.5, dict(chunk=CHUNK, exact_keep=False)),
              ("ratq", 1.0, dict(chunk=CHUNK)),
              ("ratq", 4.0, dict(chunk=CHUNK)),
              ("sparsify_then_embed", 1.0, dict(mode="randk", chunk=CHUNK)),
              ("identity", 32.0, {})]


@pytest.mark.parametrize("case", LANE_CASES, ids=_case_id)
def test_lane_stacked_calls_equal_the_per_lane_calls(case):
    """encode / encode_ef / decode over L lanes under L keys, bitwise the
    per-lane calls; the chunked leaves take their lane path (one call per
    leaf over every lane), the others go lane by lane."""
    name, budget, kw = case
    c = tcodecs.make(name, budget, **kw)
    lanes = 5
    trees = [tree_lib.map(torch.from_numpy, _tree(s)) for s in range(lanes)]
    stacked = tbase.stack(trees)
    keys = R.split(R.key(3), lanes)
    meta = c.meta(trees[0])
    assert (c.encode_lanes is not None) == (name in ("ndsc", "ratq"))
    wire = tbase.encode_lanes(c, keys, stacked, 2)
    dec = tbase.decode_lanes(c, wire, meta, lanes)
    for i in range(lanes):
        one = c.encode(keys[i], trees[i], 2)
        _same_tree(tree_lib.map(lambda x: x.numpy(), one),
                   tbase.lane(wire, i))
        assert c.wire_bytes(tbase.lane(wire, i), meta) == c.wire_bytes(
            one, meta)
        _same_tree(tree_lib.map(lambda x: x.numpy(), c.decode(one, meta)),
                   tbase.lane(dec, i))
    if c.encode_ef is not None:
        assert c.encode_ef_lanes is not None
        wire2, resid = tbase.encode_ef_lanes(c, keys, stacked, meta, 2)
        _same_tree(tree_lib.map(lambda x: x.numpy(), wire), wire2)
        for i in range(lanes):
            _, r1 = c.encode_ef(keys[i], trees[i], meta, 2)
            _same_tree(tree_lib.map(lambda x: x.numpy(), r1),
                       tbase.lane(resid, i))


def _reference_rung(rel: np.ndarray, h: int) -> np.ndarray:
    """`repro/codecs/stages.py:289-291`, eager."""
    floor = 2.0 ** (1 - h)
    return np.asarray(jnp.clip(
        jnp.ceil(jnp.log2(jnp.maximum(jnp.asarray(rel), floor))).astype(
            jnp.int32) + (h - 1), 0, h - 1))


def test_ratq_rung_sweep_matches_the_reference():
    """Every f32 within 64 ulps of each power of two from 2^(1-h) to 1 at
    h = 16, and 10^5 uniform draws: the port's rung is the reference's."""
    h = 16
    x = checks.ratq_rung_sweep(h)
    assert x.numel() == 16 * 129 + 100_000
    _same_bits(_reference_rung(x.numpy(), h), tstages.ratq_rung(x, h))


def test_ratq_rung_table_covers_every_power_of_two():
    """The port's rung table against jnp at every normal f32 within 128
    ulps of each power of two 2^-126 .. 1 (h = 127, so no rung is
    clipped): the table holds every place where XLA's log2 departs from
    the exact ⌈log2⌉, and nothing else."""
    h = 127
    offsets = np.arange(-128, 129)
    bits = (((np.arange(-126, 1)[:, None] + 127) << 23)
            + offsets[None, :]).reshape(-1)
    x = bits[bits >= 1 << 23].astype(np.int32).view(np.float32)
    _same_bits(_reference_rung(x, h),
               tstages.ratq_rung(torch.from_numpy(x), h))


@pytest.mark.parametrize("budget", [0.5, 1.0, 2.0])
def test_ratq_leaf_payload_fields(budget):
    """ratq's wire keys, dtypes and rung range; R < 1 drops whole chunks
    (zero words, rung 0) and still matches the audit to the byte."""
    c = tcodecs.make("ratq", budget, chunk=CHUNK)
    t = tree_lib.map(torch.from_numpy, _tree(4))
    w = c.encode(R.key(1), t, 0)
    for p in tree_lib.flatten_up_to(c.meta(t).treedef, w):
        assert p["words"].dtype == torch.int32
        assert p["ridx"].dtype == torch.int32
        assert p["gain"].shape == (1, 1)
        assert int(p["ridx"].min()) >= 0 and int(p["ridx"].max()) <= 15
        if budget < 1.0:
            dropped = p["mask"][:, 0] == 0
            assert not p["words"][dropped].any()
            assert not p["ridx"][dropped].any()
    assert c.wire_bytes(w, c.meta(t)) * 8 == c.wire_bits(t)
