"""The slice as a whole: repro_torch trains the reduced yi-6b like repro.

Parameters, optimizer state and EF come over from the JAX package with
`repro_torch.convert`; both sides see the same numpy tokens.

Tolerances and their reasons:
  * loss: 1e-5 relative, gradients 1e-6 abs (their scale is ~0.1): f32
    matmuls and reductions are summed in another order by XLA and torch.
  * `_consensus` on the SAME gradients: payloads bitwise, consensus and EF
    to 1e-6 abs (the codec is bitwise; only the decode's float path is
    compared by value).
  * two train steps: the gradients differ in the last bits, so an
    occasional coordinate lands in the neighbouring quantizer bin, and
    Adam's first steps move a coordinate by about ±lr whatever the size of
    its gradient, so one flipped bin can move it by up to ~2 lr. Measured
    on this test (lr = 3e-4): the largest parameter difference was 0.11 lr
    (EF) / 0.15 lr (dithered, keep 0.5) after the first step and 1.15 lr /
    1.05 lr after the second; the median was ≤ 1e-9 and at most 4% of the
    coordinates differed by more than 1e-6. So params are held to 3 lr per
    step at the maximum, 1e-7 at the median and 10% above 1e-6; the losses
    to 1e-5 relative.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.compat import shard_map
from repro.dist import gradcomp as JG
from repro.dist import step as JS
from repro.launch.mesh import make_host_mesh
from repro.models import model as JM
from repro.optimizer import adamw as jadamw
from repro.optimizer import warmup_cosine as jwarmup
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import TokenStream, batch_for_shape
from repro_torch.dist import gradcomp as TG
from repro_torch.dist import step as TS
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optimizer import optim as TO

ROOT = Path(__file__).resolve().parents[1]
LR = 3e-4


@pytest.fixture(scope="module")
def setup():
    cfg = jconfigs.get_reduced("yi-6b")
    tcfg = tconfigs.get_reduced("yi-6b")
    params = JM.init_params(jax.random.key(0), cfg)
    return cfg, tcfg, params


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, cfg, b=2, s=16):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)


def _jax_grads(cfg, params, toks):
    return jax.value_and_grad(
        lambda p: JM.loss_fn(cfg, p, {"tokens": jnp.asarray(toks)}))(params)


def test_config_matches_reference():
    for name in tconfigs.ARCH_NAMES:
        for get in ("get", "get_reduced"):
            j = dataclasses.asdict(getattr(jconfigs, get)(name))
            t = dataclasses.asdict(getattr(tconfigs, get)(name))
            assert j == t


def test_loss_and_grads_match_jax(setup):
    cfg, tcfg, params = setup
    toks = _tokens(0, cfg)
    jl, jg = _jax_grads(cfg, params, toks)
    leaves, spec = tree_lib.flatten(convert.from_numpy(_np(params)))
    diff = [p.requires_grad_() for p in leaves]
    tl = TM.loss_fn(tcfg, tree_lib.unflatten(spec, diff),
                    {"tokens": torch.from_numpy(toks)})
    tg = torch.autograd.grad(tl, diff)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jg), tg):
        assert a.shape == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)


def test_transformer_module_is_loss_fn(setup):
    cfg, tcfg, params = setup
    tp = convert.from_numpy(_np(params))
    model = TM.Transformer(tcfg, tp)
    toks = {"tokens": torch.from_numpy(_tokens(1, cfg))}
    with torch.no_grad():
        assert float(model(toks)) == float(TM.loss_fn(tcfg, tp, toks))
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == 12 and "blocks.wq" in names


@pytest.mark.parametrize("strategy", ["allgather_packed", "psum_decoded"])
def test_consensus_on_same_grads(setup, strategy):
    cfg, _, params = setup
    _, grads = _jax_grads(cfg, params, _tokens(2, cfg))
    rng = np.random.default_rng(3)
    ef = jax.tree.map(lambda g: jnp.asarray(
        1e-3 * rng.standard_normal(g.shape).astype(np.float32)), grads)
    jgc = JG.GradCompConfig(strategy=strategy)
    tgc = TG.GradCompConfig(strategy=strategy)
    mesh = make_host_mesh(data=1, model=1)
    axes = ("data",)
    fn = jax.jit(shard_map(lambda g, e: JS._consensus(g, e, jgc, axes, 3),
                           mesh=mesh, in_specs=(P(), P()),
                           out_specs=(P(), P()),
                           axis_names=set(mesh.axis_names)))
    jcons, jef = fn(grads, ef)
    tcons, tef = TS._consensus(convert.from_numpy(_np(grads)),
                               convert.from_numpy(_np(ef)), tgc, 3)
    for a, b in zip(jax.tree.leaves(jcons), tree_lib.leaves(tcons)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)
    for a, b in zip(jax.tree.leaves(jef), tree_lib.leaves(tef)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)
    # the payloads _consensus puts on the wire, leaf by leaf
    for i, (g, e) in enumerate(zip(jax.tree.leaves(grads),
                                   jax.tree.leaves(ef))):
        u = np.asarray(g) + np.asarray(e)
        jp = JG.encode_leaf(jnp.asarray(u), i, jgc, 3)
        tp = TG.encode_leaf(torch.from_numpy(u), i, tgc, 3)
        for k in jp:
            np.testing.assert_array_equal(np.asarray(jp[k]).view(np.int32),
                                          tp[k].numpy().view(np.int32))


@pytest.mark.parametrize("kw", [dict(),
                                dict(dithered=True, error_feedback=False,
                                     keep_fraction=0.5)],
                         ids=["ef", "dithered_keep0.5"])
def test_two_train_steps_match_jax(setup, kw):
    cfg, tcfg, _ = setup
    jgc, tgc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    mesh = make_host_mesh(data=1, model=1)
    jopt = jadamw(jwarmup(LR, 1, 10), weight_decay=0.1)
    topt = TO.adamw(TO.warmup_cosine(LR, 1, 10), weight_decay=0.1)
    jstep = JS.make_train_step(cfg, jopt, jgc, mesh, clip_norm=1.0)
    tstep = TS.make_train_step(tcfg, topt, tgc, clip_norm=1.0)
    jstate = JS.init_train_state(cfg, jopt, jgc, mesh, jax.random.key(0))
    tstate = tuple(convert.from_numpy(_np(s)) for s in jstate)
    for s in range(2):
        toks = _tokens(10 + s, cfg)
        *jstate, jm = jstep(*jstate, {"tokens": jnp.asarray(toks)})
        *tstate, tm = tstep(*tstate, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        diffs = np.concatenate([
            np.abs(np.asarray(a) - b.detach().numpy()).ravel()
            for a, b in zip(jax.tree.leaves(jstate[0]),
                            tree_lib.leaves(tstate[0]))])
        assert diffs.max() <= 3 * LR * (s + 1)
        assert np.median(diffs) <= 1e-7
        assert np.mean(diffs > 1e-6) <= 0.1
    assert int(tstate[1]["step"]) == 2
    if jgc.uses_ef:
        assert tree_lib.leaves(tstate[2])[0].shape[0] == 1


def test_train_cli_on_cpu_learns_shape():
    _, losses, secs = ttrain.main(["--reduced", "--steps", "2", "--batch",
                                   "2", "--seq", "8", "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert len(secs) == 2


def test_train_refuses_cpu_fallback():
    """Without --device cpu the trainer asks for CUDA; with none present it
    raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--reduced", "--steps", "1"])


def test_more_workers_raise(setup):
    """More workers, and a model axis > 1, need torch.distributed
    initialized in each rank (the multi-worker steps themselves:
    tests/test_torch_dist.py, tests/test_torch_tensor_parallel.py)."""
    from repro_torch.launch import mesh as TMESH
    with pytest.raises(RuntimeError, match="torch.distributed"):
        TMESH.make_host_group(data=2)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        TMESH.make_host_group(data=1, model=2)


def test_token_stream_deterministic():
    cfg = tconfigs.get_reduced("yi-6b")
    a = batch_for_shape(cfg, 3, 9, step=4, seed=1, device="cpu")["tokens"]
    b = batch_for_shape(cfg, 3, 9, step=4, seed=1, device="cpu")["tokens"]
    c = TokenStream(cfg.vocab_size, 9, 3, seed=1,
                    device="cpu").batch(5)["tokens"]
    assert a.shape == (3, 10) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_optimizer_and_schedule_match_jax():
    from repro.optimizer import optim as JO
    rng = np.random.default_rng(5)
    p = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    for jo, to in ((JO.adamw(JO.warmup_cosine(1e-2, 2, 9), weight_decay=0.1),
                    TO.adamw(TO.warmup_cosine(1e-2, 2, 9), weight_decay=0.1)),
                   (JO.sgd(0.1, momentum=0.9, nesterov=True),
                    TO.sgd(0.1, momentum=0.9, nesterov=True))):
        js, ts = jo.init(p), to.init(convert.from_numpy(p))
        jp, tp = p, convert.from_numpy(p)
        for _ in range(4):
            ju, js = jo.update(g, js, jp)
            tu, ts = to.update(convert.from_numpy(g), ts, tp)
            jp, tp = JO.apply_updates(jp, ju), TO.apply_updates(tp, tu)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    jn = JO.clip_by_global_norm(g, 1.0)
    tn = TO.clip_by_global_norm(convert.from_numpy(g), 1.0)
    np.testing.assert_allclose(float(tn[1]), float(jn[1]), rtol=1e-6)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"
