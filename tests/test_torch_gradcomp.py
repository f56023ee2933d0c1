"""repro_torch.dist.gradcomp vs repro.dist.gradcomp on the CPU.

Payload dicts (words, scale bits, mask) must be bitwise equal over
bits × keep {0.25, 1} × exact_keep × dither × EF; the EF residual is held
to the 4e-6 abs bound of the JAX package's EF tests (on the CPU the port
repeats the reference op for op, so it is in fact exact); decodes to
1e-6 abs; the wire ledger equals the analytic audit to the byte."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codecs import stages as jstages
from repro.dist import gradcomp as JG
from repro_torch import tree as tree_lib
from repro_torch.codecs import stages as tstages
from repro_torch.dist import gradcomp as TG

SWEEP = list(itertools.product([1, 2, 4, 8], [0.25, 1.0], [False, True],
                               [False, True], [False, True]))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((37, 19)).astype(np.float32),
            "b": rng.standard_normal((64,)).astype(np.float32),
            "nested": {"v": rng.standard_normal((3, 5, 7)).astype(
                np.float32)},
            "a": rng.standard_normal((300,)).astype(np.float32)}


def _assert_payload_equal(jp, tp):
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]).view(np.int32),
                                      tp[k].numpy().view(np.int32))


@pytest.mark.parametrize("bits,keep,exact,dither,ef", SWEEP)
def test_leaf_payloads_bitwise(bits, keep, exact, dither, ef):
    kw = dict(bits=bits, chunk=64, keep_fraction=keep, exact_keep=exact,
              dithered=dither, error_feedback=ef)
    jc, tc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    x = np.random.default_rng(bits).standard_normal((37, 19)).astype(
        np.float32)
    if ef:
        jp, jr = JG.encode_leaf_ef(jnp.asarray(x), 3, jc, 5)
        tp, tr = TG.encode_leaf_ef(torch.from_numpy(x), 3, tc, 5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=4e-6,
                                   rtol=0)
    else:
        jp = JG.encode_leaf(jnp.asarray(x), 3, jc, 5)
        tp = TG.encode_leaf(torch.from_numpy(x), 3, tc, 5)
    _assert_payload_equal(jp, tp)
    jd = JG.decode_leaf(jp, 3, x.size, x.shape, jnp.float32, jc)
    td = TG.decode_leaf(tp, 3, x.size, x.shape, torch.float32, tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)


def test_flatten_order_matches_jax():
    """Leaf i of the port is leaf i of jax.tree.flatten (sorted dict keys),
    which is what numbers each leaf's frame."""
    t = _tree(0)
    jl = jax.tree.leaves(t)
    tl, spec = tree_lib.flatten(t)
    assert [a.shape for a in jl] == [a.shape for a in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    back = tree_lib.unflatten(spec, tl)
    assert jax.tree.structure(back) == jax.tree.structure(t)


@pytest.mark.parametrize("keep,exact", [(1.0, False), (0.25, True)])
def test_tree_codec_and_stacked_decode(keep, exact):
    kw = dict(bits=4, chunk=32, keep_fraction=keep, exact_keep=exact)
    jc, tc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    t = _tree(1)
    jp, jmeta = JG.compress_tree(jax.tree.map(jnp.asarray, t), jc, 2)
    tp, tmeta = TG.compress_tree(tree_lib.map(torch.from_numpy, t), tc, 2)
    for a, b in zip(JG._payload_leaves(jp), TG._payload_leaves(tp)):
        _assert_payload_equal(a, b)
    jd = jax.tree.leaves(JG.decode_payload(jp, jmeta, jc))
    td = tree_lib.leaves(TG.decode_payload(tp, tmeta, tc))
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    # the all-gathered worker axis: decode with extra_lead=1
    stacked = tree_lib.map(lambda x: x[None], tp)
    td1 = tree_lib.leaves(TG.decode_payload(stacked, tmeta, tc,
                                            extra_lead=1))
    for a, b in zip(td, td1):
        assert b.shape == (1,) + tuple(a.shape)
        np.testing.assert_array_equal(b[0].numpy(), a.numpy())


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("keep,exact", [(1.0, False), (0.5, True),
                                        (0.25, True), (0.5, False)])
def test_ledger_equals_audit_to_the_byte(bits, keep, exact):
    kw = dict(bits=bits, chunk=32, keep_fraction=keep, exact_keep=exact)
    jc, tc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    t = _tree(2)
    tt = tree_lib.map(torch.from_numpy, t)
    audit = TG.wire_bytes_tree(tt, tc, num_workers=4)
    assert audit == JG.wire_bytes_tree(jax.tree.map(jnp.asarray, t), jc,
                                       num_workers=4)
    tp, _ = TG.compress_tree(tt, tc, 7)
    jp, _ = JG.compress_tree(jax.tree.map(jnp.asarray, t), jc, 7)
    ledger = TG.wire_bytes_payload(tp, tc)
    assert ledger == JG.wire_bytes_payload(jp, jc)
    if keep == 1.0 or exact:
        assert ledger == audit["payload_bytes"]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_exact_keep_mask_ties_match_jax(k):
    draws = np.array([[0.5], [0.1], [0.5], [0.1], [0.5], [0.9]], np.float32)
    want = JG._exact_keep_mask(jnp.asarray(draws), k)
    got = TG._exact_keep_mask(torch.from_numpy(draws), k)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert int(got.sum()) == k


def test_ndsc_leaf_delegates_and_audits():
    gc_kw = dict(bits=2, chunk=64, keep_fraction=0.5, exact_keep=True)
    jl = jstages.ndsc_leaf(JG.GradCompConfig(**gc_kw))
    tl = tstages.ndsc_leaf(TG.GradCompConfig(**gc_kw))
    assert tl.wire_bits(1000) == jl.wire_bits(1000)
    assert tl.effective_bits == jl.effective_bits
    x = np.random.default_rng(4).standard_normal(1000).astype(np.float32)
    jp = jl.encode(jnp.asarray(x), 2, 3)
    tp = tl.encode(torch.from_numpy(x), 2, 3)
    _assert_payload_equal(jp, tp)
    assert tl.wire_bytes(tp, 1000) * 8 == tl.wire_bits(1000)


def test_config_validation():
    for bad in (dict(bits=3), dict(chunk=48), dict(strategy="x"),
                dict(keep_fraction=0.0)):
        with pytest.raises(ValueError):
            TG.GradCompConfig(**bad)
