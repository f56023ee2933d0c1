"""repro_torch.checkpoint against repro.checkpoint on the CPU, and its own
bitwise contracts.

Key paths: `tree.keystr` equals `jax.tree_util.keystr` on the same trees.
Unit: a round trip is bitwise for f32, int32, uint32, int64-scalar and bf16
leaves (bf16 read back from the port's own files and from the reference's,
which numpy shows as 2-byte voids), restore casts to the template's dtype,
a mismatched structure raises, `latest_step` finds the newest step.

Port against port (mirrors tests/test_checkpoint_fed.py, its `_problem`:
m 4, dim 48, n 32): a federation resumed from a checkpoint is bitwise the
uninterrupted one, static and adaptive, round counter and PRNG lanes
included.

Across packages: the same federation, and the {"params", "opt_state"}
trees of a reduced config, give equal manifests (paths, shapes, dtypes);
a checkpoint written by either package restores into the other, whose
next rounds give the writer's ledger byte for byte and params within
PARAM_TOL (as tests/test_torch_fed.py: the reference runs each round under
`jit`, which may flip a quantization bin). The reference cannot restore a
bf16 leaf at all (numpy has no cast from its 2-byte void to bfloat16), so
bf16 crosses only into the port.
"""
import json
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import codecs as jcodecs
from repro import configs as jconfigs
from repro import fed as jfed
from repro.models import model as jmodel
from repro.optimizer import optim as joptim
from repro_torch import checkpoint as tckpt
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import fed as tfed
from repro_torch import tree as tree_lib
from repro_torch.dist import step as tstep
from repro_torch.dist.gradcomp import GradCompConfig
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optimizer import optim as toptim

PARAM_TOL = 1e-4          # max |Δx| / max |x|, port against the reference


class Pair(NamedTuple):
    left: object
    right: object


# ---------------------------------------------------------------------------
# key paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tree", [
    {"b": [np.ones(2), (np.ones(1), None)], "a": np.ones(3)},
    Pair(left={"z": np.ones(1), "y": [np.ones(2)]}, right=None),
    [{"k": Pair(np.ones(1), (np.ones(1),))}, None, np.ones(4)],
    np.ones(5),
], ids=["dict-list-tuple-none", "namedtuple", "list-root", "leaf-root"])
def test_keystr_matches_jax(tree):
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    pairs, _ = tree_lib.flatten_with_path(tree)
    assert [tree_lib.keystr(p) for p, _ in pairs] == want


# ---------------------------------------------------------------------------
# unit: round trip, structure, latest_step
# ---------------------------------------------------------------------------
def _leaves():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g),
            "i32": torch.arange(-4, 4, dtype=torch.int32),
            "u32": np.array([0, 1, 2 ** 32 - 1], np.uint32),
            "i64": np.asarray(2 ** 40 + 3, np.int64),
            "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
            "nested": [torch.ones(2), None]}


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(
                    a.contiguous().reshape(-1).view(torch.uint8),
                    b.contiguous().reshape(-1).view(torch.uint8)))
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def test_round_trip_is_bitwise_and_casts_to_the_template(tmp_path):
    tree = _leaves()
    path = tckpt.save_checkpoint(str(tmp_path), 3, tree)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    dtypes = {leaf["path"]: leaf["dtype"] for leaf in manifest["leaves"]}
    assert dtypes["['bf16']"] == "bfloat16"
    assert dtypes["['u32']"] == "uint32" and dtypes["['i64']"] == "int64"
    back, step = tckpt.restore_checkpoint(str(tmp_path), tree)
    assert step == 3
    for a, b in zip(tree_lib.leaves(tree), tree_lib.leaves(back)):
        assert _same(a, b)
    like = dict(tree, f32=torch.zeros(3, 5, dtype=torch.float64))
    cast, _ = tckpt.restore_checkpoint(str(tmp_path), like)
    assert cast["f32"].dtype == torch.float64
    assert torch.equal(cast["f32"], tree["f32"].double())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bf16_leaf_is_read_from_its_bits(tmp_path, writer):
    x = torch.randn(33, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    if writer == "port":
        tckpt.save_checkpoint(str(tmp_path), 0, {"r": x})
    else:
        jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        jckpt.save_checkpoint(str(tmp_path), 0, {"r": jx})
    with np.load(str(tmp_path / "step_0" / "arrays.npz")) as z:
        assert z["a0"].dtype.itemsize == 2
    back, _ = tckpt.restore_checkpoint(
        str(tmp_path), {"r": torch.zeros(33, dtype=torch.bfloat16)})
    assert _same(back["r"], x)


def test_restore_rejects_mismatched_structure(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), {"b": torch.ones(2)})


def test_latest_step_and_missing_checkpoint(tmp_path):
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path), {"a": torch.ones(1)})
    for s in (2, 10, 7):
        tckpt.save_checkpoint(str(tmp_path), s, {"a": torch.full((1,), s)})
    assert tckpt.latest_step(str(tmp_path)) == 10
    back, step = tckpt.restore_checkpoint(str(tmp_path),
                                          {"a": torch.zeros(1)})
    assert step == 10 and float(back["a"]) == 10.0


# ---------------------------------------------------------------------------
# federations: tests/test_checkpoint_fed.py's problem in both packages
# ---------------------------------------------------------------------------
def _problem(seed=2):
    rng = np.random.default_rng(seed)
    m, dim, n = 4, 48, 32
    a = (rng.standard_normal((m, n, dim)) / np.sqrt(n)).astype(np.float32)
    x_true = rng.standard_normal(dim).astype(np.float32)
    scales = np.logspace(-1, 1, m)
    return [{"a": (scales[i] * a[i]).astype(np.float32),
             "b": (scales[i] * (a[i] @ x_true)).astype(np.float32)}
            for i in range(m)]


def _jloss(p, batch):
    r = batch["a"] @ p["x"] - batch["b"]
    return 0.5 * jnp.mean(r * r)


def _tloss(p, batch):
    r = batch["a"] @ p["x"] - batch["b"]
    return 0.5 * torch.mean(r * r)


def _build(pkg, shards, adaptive=True):
    """The reference test's federation (fedopt, SGD momentum 0.5, ndsc
    budgets of 2 bits, optionally adaptive) in package `pkg`."""
    torch_side = pkg == "port"
    fed, codecs_, opt = ((tfed, tcodecs, toptim) if torch_side
                         else (jfed, jcodecs, joptim))
    factory = lambda r: codecs_.make("ndsc", budget=float(r), chunk=32)
    acfg = (fed.AdaptiveConfig(total_rate=8.0, realloc_every=2, grid=0.25,
                               hysteresis=0.25, min_rate=0.25)
            if adaptive else None)
    dim = shards[0]["a"].shape[1]
    kw = {"device": "cpu"} if torch_side else {}
    return fed.Federation(
        _tloss if torch_side else _jloss,
        {"x": torch.zeros(dim) if torch_side else jnp.zeros(dim)},
        [tree_lib.map(torch.from_numpy, s) if torch_side
         else tree_lib.map(jnp.asarray, s) for s in shards],
        [factory(2.0) for _ in shards],
        fed.ClientConfig(local_steps=2, lr=0.3),
        fed.ServerConfig(aggregator="fedopt",
                         optimizer=opt.sgd(1.0, momentum=0.5)),
        seed=7, adaptive=acfg, codec_factory=factory if acfg else None,
        **kw)


def _cfg(pkg, rounds):
    fed = tfed if pkg == "port" else jfed
    return fed.FedConfig(num_rounds=rounds, participation=0.9, dropout=0.1,
                         seed=4)


LEDGER = ("round", "participants", "stragglers", "wire_bytes",
          "analytic_bytes", "realloc", "rates")


@pytest.mark.parametrize("adaptive", [False, True],
                         ids=["static", "adaptive"])
def test_resumed_port_run_is_bitwise_the_uninterrupted_one(tmp_path,
                                                           adaptive):
    """10 rounds straight against 5 → save → fresh federation → restore →
    5 more: the round-5..9 ledger and every piece of state bitwise."""
    shards = _problem()
    ref = _build("port", shards, adaptive)
    h_ref = ref.run(_cfg("port", 10))
    half = _build("port", shards, adaptive)
    half.run(_cfg("port", 5))
    tckpt.save_federation(str(tmp_path), half)
    resumed = _build("port", shards, adaptive)
    assert tckpt.restore_federation(str(tmp_path), resumed) == 5
    assert resumed.rounds_done == 5
    h_res = resumed.run(_cfg("port", 5))
    for k in LEDGER:
        assert h_ref[k][5:] == h_res[k], k
    for a, b in zip(tree_lib.leaves(tckpt.federation_state(ref)),
                    tree_lib.leaves(tckpt.federation_state(resumed))):
        assert _same(a, b)
    for s_ref, s_res in zip(ref.states, resumed.states):
        assert s_ref.key.dtype == s_res.key.dtype == torch.int64
        assert torch.equal(s_ref.key, s_res.key)
    if adaptive:
        assert any(h_ref["realloc"])
        np.testing.assert_array_equal(ref._rates, resumed._rates)


def test_federation_state_covers_round_counter_and_keys(tmp_path):
    fed = _build("port", _problem(), adaptive=False)
    fed.run(_cfg("port", 3))
    tree = tckpt.federation_state(fed)
    assert int(tree["round"]) == 3
    assert [k.dtype for k in tree["clients"]["key_data"]] == [np.uint32] * 4
    tckpt.save_federation(str(tmp_path), fed, step=3)
    other = _build("port", _problem(), adaptive=False)
    tckpt.restore_federation(str(tmp_path), other, step=3)
    for a, b in zip(fed.states, other.states):
        assert torch.equal(a.key, b.key)
    smaller = _build("port", _problem()[:3], adaptive=False)
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore_federation(str(tmp_path), smaller)


def _manifest(path):
    leaves = json.load(open(os.path.join(path, "manifest.json")))["leaves"]
    return [(leaf["path"], leaf["shape"], leaf["dtype"]) for leaf in leaves]


def test_federation_manifests_are_equal_across_packages(tmp_path):
    shards = _problem()
    pj = jckpt.save_federation(str(tmp_path / "ref"),
                               _build("reference", shards))
    pt = tckpt.save_federation(str(tmp_path / "port"),
                               _build("port", shards))
    assert _manifest(pt) == _manifest(pj)


def test_train_state_manifests_are_equal_across_packages(tmp_path):
    """{"params", "opt_state"} of the reduced yi-6b under AdamW, as
    `launch.train --ckpt-dir` writes it in either package."""
    cfg_j, cfg_t = (jconfigs.get_reduced("yi-6b"),
                    tconfigs.get_reduced("yi-6b"))
    p_j = jmodel.init_params(jax.random.key(0), cfg_j)
    p_t = tmodel.init_params(0, cfg_t, "cpu")
    o_j = joptim.adamw(3e-4, weight_decay=0.1)
    o_t = toptim.adamw(3e-4, weight_decay=0.1)
    pj = jckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                               {"params": p_j, "opt_state": o_j.init(p_j)})
    pt = tckpt.save_checkpoint(str(tmp_path / "port"), 1,
                               {"params": p_t, "opt_state": o_t.init(p_t)})
    assert _manifest(pt) == _manifest(pj)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """`writer` runs 4 rounds, saves, and runs 4 more; the other package
    restores the checkpoint into a fresh federation and runs the same 4:
    ledger byte for byte, params within PARAM_TOL."""
    reader = "port" if writer == "reference" else "reference"
    lib = {"port": tckpt, "reference": jckpt}
    shards = _problem()
    src = _build(writer, shards)
    src.run(_cfg(writer, 4))
    lib[writer].save_federation(str(tmp_path), src)
    h_src = src.run(_cfg(writer, 4))
    dst = _build(reader, shards)
    assert lib[reader].restore_federation(str(tmp_path), dst) == 4
    h_dst = dst.run(_cfg(reader, 4))
    for k in LEDGER:
        assert h_dst[k] == h_src[k], k
    assert any(h_src["realloc"])
    want = np.asarray(src.server.params["x"])
    got = np.asarray(dst.server.params["x"])
    assert np.abs(got - want).max() / np.abs(want).max() < PARAM_TOL


def test_train_launcher_checkpoint_restores_bitwise(tmp_path, capsys):
    cfg = tconfigs.get_reduced("yi-6b")
    gc = GradCompConfig(bits=4)
    params, _, _ = ttrain.train(cfg, steps=2, batch_size=2, seq_len=8, gc=gc,
                                log_every=10, device="cpu",
                                ckpt_dir=str(tmp_path))
    assert "checkpoint → " in capsys.readouterr().out
    opt = toptim.adamw(3e-4, weight_decay=0.1)
    like_p, like_o, _ = tstep.init_train_state(cfg, opt, gc, device="cpu")
    back, step = tckpt.restore_checkpoint(
        str(tmp_path), {"params": like_p, "opt_state": like_o})
    assert step == 2 and int(back["opt_state"]["step"]) == 2
    for a, b in zip(tree_lib.leaves(params), tree_lib.leaves(back["params"])):
        assert _same(a, b)
