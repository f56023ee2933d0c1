"""The other block families, configs and input shapes of repro_torch
against the JAX package's, on the CPU: attn_moe (mixtral), attn_moe_dense
(arctic), hybrid with both scans (hymba), xlstm_pair (xlstm), encoder with
the audio frontend (hubert) and the vision frontend (pixtral), at their
reduced configs (2 layers, seq ≤ 32). JAX parameters are carried over with
`repro_torch.convert`; both sides see the same numpy inputs.

Tolerances and their reasons:
  * loss 1e-5 relative, gradients 1e-6 abs, as tests/test_torch_train.py:
    f32 matmuls and reductions are summed in another order by XLA and
    torch, and the recurrent scans carry that through every step.
    Measured over the seven cases: loss ≤ 8.7e-8 relative, gradients
    ≤ 1.2e-7 abs;
  * logits 5e-6 abs (their scale is ~0.1–1), LOGIT_TOL of
    tests/test_torch_decode.py; measured ≤ 6.0e-7;
  * MoE routing is discrete, so it is held exactly: the top-k experts, each
    assignment's rank within its expert, the keep mask and the drop
    fraction; the load-balance loss within 1e-6 and the MoE output within
    1e-6 abs;
  * the codec over a tree with NamedTuple leaves (hymba, xlstm): payload
    words and scales bitwise the eager reference's, leaf for leaf in
    `jax.tree` order, decodes within 1e-6, ledger == audit to the byte.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.dist import gradcomp as JG
from repro.dist import sharding as JSH
from repro.models import decode as JD
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import batch_for_shape
from repro_torch.dist import gradcomp as TG
from repro_torch.dist import sharding as TSH
from repro_torch.dist import step as TS
from repro_torch.launch import train as ttrain
from repro_torch.models import decode as TD
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

LOGIT_TOL = 5e-6
UNFUSED = {"xla_disable_hlo_passes": "fusion",
           "xla_backend_optimization_level": 0}
# family id → (arch, fields replaced on the reduced config, both packages)
FAMILIES = {
    "attn_moe": ("mixtral-8x22b", {}),
    "attn_moe_dense": ("arctic-480b", {}),
    "hybrid": ("hymba-1.5b", {}),
    "hybrid_assoc_remat": ("hymba-1.5b", {"ssm_scan": "associative",
                                          "remat": True}),
    "xlstm_pair": ("xlstm-350m", {}),
    "encoder_audio": ("hubert-xlarge", {}),
    "vision": ("pixtral-12b", {}),
}
_CACHE: dict = {}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def family(fid):
    """(JAX cfg, port cfg, JAX params, port params), built once."""
    if fid not in _CACHE:
        arch, kw = FAMILIES[fid]
        cfg = dataclasses.replace(jconfigs.get_reduced(arch), **kw)
        tcfg = dataclasses.replace(tconfigs.get_reduced(arch), **kw)
        params = JM.init_params(jax.random.key(0), cfg)
        _CACHE[fid] = (cfg, tcfg, params, convert.from_numpy(_np(params)))
    return _CACHE[fid]


def _batch(cfg, seed, b=2, s=24):
    """Numpy inputs: tokens (b, s + 1); the audio frontend's frame
    embeddings and targets (one ignored, −1); the vision frontend's 16
    image embeddings before s − 16 text tokens."""
    rng = np.random.default_rng(seed)
    toks = lambda n: rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    if cfg.frontend == "audio":
        targets = toks(s)
        targets[0, 3] = -1
        return {"embeds": 0.02 * rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32), "targets": targets}
    if cfg.frontend == "vision":
        return {"image_embeds": 0.02 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32),
            "tokens": toks(s - cfg.num_patches + 1)}
    return {"tokens": toks(s + 1)}


@pytest.mark.parametrize("fid", list(FAMILIES))
def test_loss_and_grads_match_jax(fid):
    cfg, tcfg, params, tparams = family(fid)
    batch = _batch(cfg, 0)
    jl, jg = jax.value_and_grad(lambda p: JM.loss_fn(
        cfg, p, jax.tree.map(jnp.asarray, batch)))(params)
    leaves, spec = tree_lib.flatten(tparams)
    diff = [p.detach().clone().requires_grad_() for p in leaves]
    tl = TM.loss_fn(tcfg, tree_lib.unflatten(spec, diff),
                    convert.from_numpy(batch))
    tg = torch.autograd.grad(tl, diff)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("fid", list(FAMILIES))
def test_logits_match_jax(fid):
    cfg, tcfg, params, tparams = family(fid)
    batch = _batch(cfg, 1)
    want = JM.logits_fn(cfg, params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = TM.logits_fn(tcfg, tparams, convert.from_numpy(batch))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_TOL, rtol=0)


def _jax_routing(x, router, k, cf):
    """The reference's routing (repro/models/moe.py, the lines from the
    router softmax to the keep mask), spelled out, since its moe_ffn keeps
    them internal."""
    t = x.shape[0]
    e = router.shape[-1]
    probs = jax.nn.softmax((x @ router).astype(jnp.float32), axis=-1)
    weights, expert_idx = jax.lax.top_k(probs, k)
    flat_e = expert_idx.reshape(t * k)
    capacity = max(1, int(cf * t * k / e))
    order = jnp.argsort(flat_e, stable=True)
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.cumsum(counts) - counts
    rank_sorted = jnp.arange(t * k, dtype=jnp.int32) - starts[flat_e[order]]
    rank = jnp.zeros(t * k, jnp.int32).at[order].set(rank_sorted)
    return expert_idx, rank, rank < capacity


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("fid", ["attn_moe", "attn_moe_dense"])
def test_moe_routing_matches_jax(fid, cf):
    """Layer 0's router and experts on 2 × 16 tokens; at capacity factor
    0.5 tokens are dropped."""
    cfg, _, params, tparams = family(fid)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jb = jax.tree.map(lambda a: a[0], params["blocks"])
    tb = TM.layer_params(tparams, 0)
    names = ("router", "e_gate", "e_up", "e_down")
    jout, jaux = JMOE.moe_ffn(jnp.asarray(x), *(jb[n] for n in names),
                              top_k=cfg.top_k, capacity_factor=cf,
                              return_aux=True)
    tout, taux = TMOE.moe_ffn(torch.from_numpy(x), *(tb[n] for n in names),
                              top_k=cfg.top_k, capacity_factor=cf,
                              return_aux=True)
    jidx, jrank, jkeep = _jax_routing(jnp.asarray(x.reshape(32, -1)),
                                      jb["router"], cfg.top_k, cf)
    r = TMOE.route(torch.from_numpy(x.reshape(32, -1)), tb["router"],
                   cfg.top_k, cf)
    np.testing.assert_array_equal(r["expert_idx"].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(r["rank"].numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(jkeep))
    assert float(taux["drop_fraction"]) == float(jaux["drop_fraction"])
    if cf < 1:
        assert float(taux["drop_fraction"]) > 0
    np.testing.assert_allclose(float(taux["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), atol=1e-6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6,
                               rtol=0)


def test_top_k_keeps_lax_tie_order():
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.0], [1.0, 1.0, 1.0, 1.0, 1.0]],
                 np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = TMOE.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_NAMES))
def test_param_tree_and_counts_match_jax(arch):
    """Full configs, no allocation: leaf shapes in `jax.tree` order,
    param_count, active_param_count and the placement rules at a model
    axis of 16 equal the reference's."""
    cfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    jshapes = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), cfg))
    tshapes = TM.param_shapes(tcfg)
    assert [a.shape for a in jax.tree.leaves(jshapes)] == \
        tree_lib.leaves(tshapes, is_leaf=TM.is_shape)
    assert TM.param_count(tcfg) == JM.param_count(cfg)
    assert TM.active_param_count(tcfg) == JM.active_param_count(cfg)
    jspecs = jax.tree.leaves(JSH.param_specs(jshapes, 16),
                             is_leaf=lambda s: isinstance(s, jax.sharding.
                                                          PartitionSpec))
    tspecs = tree_lib.leaves(
        TSH.param_specs(tshapes, 16),
        is_leaf=lambda s: isinstance(s, tuple) and not hasattr(s, "_fields"))
    assert [tuple(s) for s in jspecs] == tspecs
    meta = TS.meta_params(tcfg)
    assert [tuple(x.shape) for x in tree_lib.leaves(meta)] == \
        tree_lib.leaves(tshapes, is_leaf=TM.is_shape)


@pytest.mark.parametrize("arch", list(jconfigs.ARCH_NAMES))
def test_shapes_applicable_and_input_specs_match_jax(arch):
    cfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, jshape in jconfigs.SHAPES.items():
        tshape = tconfigs.SHAPES[name]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(jshape)
        assert tconfigs.applicable(tcfg, tshape) == \
            jconfigs.applicable(cfg, jshape)
        if jshape.mode == "decode":
            continue
        jspec = jconfigs.input_specs(cfg, jshape)
        tspec = tconfigs.input_specs(tcfg, tshape)
        assert sorted(jspec) == sorted(tspec)
        for k, v in jspec.items():
            assert tspec[k].device.type == "meta"
            assert tuple(tspec[k].shape) == v.shape, (k, name)
            assert str(tspec[k].dtype).split(".")[-1] == str(v.dtype), k


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m",
                                  "mixtral-8x22b", "hubert-xlarge"])
def test_serve_state_specs_match_jax(arch):
    """decode_32k's state at the full config as `meta` tensors: the
    reference's leaves and shapes; an encoder has none."""
    cfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    b, s = 4, 32768
    if not cfg.decode_supported:
        with pytest.raises(ValueError, match="encoder-only"):
            TS.serve_state_specs(tcfg, None, b, s)
        return
    jstate = JD.decode_state_specs(cfg, b, s)
    _, tstate, tok = TS.serve_state_specs(tcfg, None, b, s)
    assert sorted(jstate.caches) == sorted(tstate.caches)
    for k, v in jstate.caches.items():
        assert tstate.caches[k].shape == v.shape, k
    assert tok.shape == (b, 1)
    # the decode module's own specs: meta tensors, the reference's dtypes
    specs = TD.decode_state_specs(tcfg, b, s)
    for k, v in jstate.caches.items():
        x = specs.caches[k]
        assert x.device.type == "meta" and tuple(x.shape) == v.shape, k
        assert str(x.dtype).split(".")[-1] == str(v.dtype), k


@pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b",
                                  "mixtral-8x22b"])
def test_batch_for_shape_has_input_specs_layout(arch):
    tcfg = tconfigs.get_reduced(arch)
    shape = tconfigs.InputShape("tiny", 24, 3, "train")
    spec = tconfigs.input_specs(tcfg, shape)
    b1 = batch_for_shape(tcfg, 3, 24, step=2, seed=1, device="cpu")
    b2 = batch_for_shape(tcfg, 3, 24, step=2, seed=1, device="cpu")
    b3 = batch_for_shape(tcfg, 3, 24, step=3, seed=1, device="cpu")
    assert sorted(b1) == sorted(spec)
    for k, v in spec.items():
        assert b1[k].shape == v.shape and b1[k].dtype == v.dtype, k
        assert torch.equal(b1[k], b2[k]) and not torch.equal(b1[k], b3[k])
    for k in ("tokens", "targets"):
        if k in b1:
            assert 0 <= int(b1[k].min()) and int(b1[k].max()) < tcfg.vocab_size


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-350m"])
def test_gradcomp_over_namedtuple_tree_bitwise(arch):
    """The codec over the reduced tree with its NamedTuple leaves, filled
    with seeded values: payloads bitwise the eager reference's in
    `jax.tree` order, decodes within 1e-6, ledger == audit."""
    cfg = jconfigs.get_reduced(arch)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), cfg))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32) * 1e-2, shapes)
    kw = dict(bits=4, chunk=64)
    jc, tc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    jt, tt = jax.tree.map(jnp.asarray, tree), convert.from_numpy(tree)
    assert [a.shape for a in jax.tree.leaves(jt)] == \
        [tuple(b.shape) for b in tree_lib.leaves(tt)]
    # the reference's tree encode compiled as one program with XLA's fusion
    # pass off rounds every op as its eager ops do (tests/test_torch_dist.py)
    # and compiles in seconds, where the eager ops compile per leaf shape
    jp = jax.jit(lambda t: JG.compress_tree(t, jc, 5)[0]).lower(
        jt).compile(compiler_options=UNFUSED)(jt)
    jmeta = (jax.tree.structure(jt),
             [(x.size, tuple(x.shape), x.dtype) for x in jax.tree.leaves(jt)])
    tp, tmeta = TG.compress_tree(tt, tc, 5)
    jpl, tpl = JG._payload_leaves(jp), TG._payload_leaves(tp)
    assert len(jpl) == len(tpl) == len(jax.tree.leaves(jt))
    for a, b in zip(jpl, tpl):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]).view(np.int32),
                                          b[k].numpy().view(np.int32))
    jd = jax.jit(lambda p: JG.decode_payload(p, jmeta, jc))(jp)
    for a, b in zip(jax.tree.leaves(jd),
                    tree_lib.leaves(TG.decode_payload(tp, tmeta, tc))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)
    audit = TG.wire_bytes_tree(tt, tc)
    assert audit == JG.wire_bytes_tree(jt, jc)
    assert TG.wire_bytes_payload(tp, tc) == audit["payload_bytes"]


def test_transformer_module_holds_namedtuple_leaves():
    _, tcfg, _, tparams = family("hybrid")
    model = TM.Transformer(tcfg, tparams)
    names = dict(model.named_parameters())
    assert "blocks.mamba.in_proj" in names and "embed" in names
    assert len(names) == len(tree_lib.leaves(tparams))
    back = model.params()
    assert tree_lib.flatten(back)[1] == tree_lib.flatten(tparams)[1]
    batch = convert.from_numpy(_batch(family("hybrid")[0], 4))
    with torch.no_grad():
        assert float(model(batch)) == float(TM.loss_fn(tcfg, tparams, batch))
    _, acfg, _, aparams = family("encoder_audio")
    assert "embed" not in dict(TM.Transformer(acfg, aparams)
                               .named_parameters())


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "hubert-xlarge",
                                  "xlstm-350m"])
def test_train_cli_takes_every_family(arch):
    _, losses, _ = ttrain.main(["--arch", arch, "--reduced", "--steps", "2",
                                "--batch", "2", "--seq", "8", "--device",
                                "cpu"])
    assert len(losses) == 2 and all(map(math.isfinite, losses))


def test_init_params_follows_the_reference_rules():
    """Shapes and dtypes of the reference, and its constant leaves
    exactly: the Mamba Δ bias, A_log and skip, the norms; the mLSTM forget
    gate around 3."""
    for arch in ("hymba-1.5b", "xlstm-350m", "arctic-480b"):
        cfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
        jp = _np(JM.init_params(jax.random.key(0), cfg))
        tp = TM.init_params(0, tcfg, "cpu")
        jl, tl = jax.tree.leaves(jp), tree_lib.leaves(tp)
        assert [a.shape for a in jl] == [tuple(b.shape) for b in tl]
        assert [a.dtype for a in jl] == [b.numpy().dtype for b in tl]
    cfg = jconfigs.get_reduced("hymba-1.5b")
    jp = _np(JM.init_params(jax.random.key(0), cfg))
    tp = TM.init_params(0, tconfigs.get_reduced("hymba-1.5b"), "cpu")
    for f in ("dt_bias", "d_skip"):
        np.testing.assert_array_equal(
            getattr(tp["blocks"]["mamba"], f).numpy(),
            getattr(jp["blocks"]["mamba"], f))
    # log(1..n): torch's and XLA's log differ in the last bit of some
    np.testing.assert_allclose(tp["blocks"]["mamba"].a_log.numpy(),
                               jp["blocks"]["mamba"].a_log, rtol=2e-7,
                               atol=0)
    np.testing.assert_array_equal(tp["blocks"]["mlp_norm"].numpy(),
                                  jp["blocks"]["mlp_norm"])
    xcfg = tconfigs.get_reduced("xlstm-350m")
    wf = TM.init_params(0, xcfg, "cpu")["blocks"]["mlstm"].wf
    assert abs(float(wf.mean()) - 3.0) < 0.01
