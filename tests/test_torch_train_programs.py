"""The captured training programs on the CPU, against the JAX package's
jitted ones.

The train steps (`dist.step.make_train_step`, `make_zero_train_step`),
the federation's client rounds (`fed.clients`), decodes (`fed.rounds`) and
aggregates (`fed.server`) are `repro_torch.graph.Program`s. On the CPU a
program runs eagerly on static copies of its copied arguments, its bound
state in place, and clones its other outputs, so what is held here is what
the card's graphs rest on:

  * `random.fold_in` takes the traced step counter (a 0-d tensor): bitwise
    its int for data 0, 1, 2^31 − 1, 2^31 and 2^32 − 1, and the reference's;
  * the specializations (`obs.recompile`) against the reference's jitted
    programs' `_cache_size`: the train step (allgather_packed + EF,
    psum_decoded, dithered + keep mask: 3 steps, then a new batch shape),
    ZeRO-1 (2 steps) and a small fed_heterogeneous-like federation at 50%
    participation (fedmem). The reference compiles a train step's first
    call once more than the port when its state is placed with
    spelled-out specs (P(None, ...)) and the step returns it as P(): the
    same placement under another cache key (ROADMAP §3). So the
    strategies' and ZeRO-1's reference state is placed as the step
    returns it (`test_torch_obs.py` holds the extra one). Its scalar
    client round also compiles once more for a state that came back from
    a cohort round (numpy leaves after `device_get`), so the federation's
    traffic is one where no client goes from a cohort to the scalar path,
    which the test asserts;
  * the Program's CPU path gives the reduced yi-6b's (1 layer) params,
    AdamW state, EF, loss and grad_norm after 3 steps bitwise
    `graph.eager()`'s (with EF, and dithered with keep 0.5), ZeRO-1's
    after 2, and the federation's
    ledger, participants, params and client states; the step returns the
    caller's state tensors;
  * the dithered step's payload at step t, salted by the traced counter,
    is bitwise the reference's at step t.

The strategies' counts run on a one-leaf tree with a stand-in loss at
chunk 32 (each reference compile of the reduced yi-6b's step takes ~7 s
on the CPU); ZeRO-1's on the reduced yi-6b's tree with a stand-in loss.
The card's side
(graph against eager, bitwise) is `tests/test_torch_cuda.py -k
train_graphs` and `chip_smoke.py` phase 17.
"""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro import codecs as jcodecs
from repro import configs as jconfigs
from repro import fed as jfed
from repro.dist import gradcomp as JG
from repro.dist import step as JS
from repro.launch.mesh import make_host_mesh
from repro.obs import recompile as jrecompile
from repro.optimizer import adamw as jadamw
from repro.optimizer import warmup_cosine as jwarmup
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import fed as tfed
from repro_torch import graph
from repro_torch import random as R
from repro_torch import tree as tree_lib
from repro_torch.dist import gradcomp as TG
from repro_torch.dist import step as TS
from repro_torch.obs import recompile
from repro_torch.optimizer import optim as TO
from test_torch_fed import _jloss, _problem, _tloss

LR = 3e-4
STRATEGIES = {"allgather_ef": {},
              "psum_decoded": {"strategy": "psum_decoded"},
              "dithered_keep": {"dithered": True, "error_feedback": False,
                                "keep_fraction": 0.5}}
# the federation: 4 clients at two rates; its sampling seed gives rounds
# of scalar rounds only and one with a cohort (two clients of rate 1)
FED_RATES = (1.0, 1.0, 2.0, 2.0)
FED_ROUNDS, FED_SEED = 4, 11
# the reference's encode compiled with XLA's fusion pass off, where it
# rounds each op as written (tests/test_torch_dist.py)
UNFUSED = {"xla_disable_hlo_passes": "fusion",
           "xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: run beside other
    pytest-xdist workers, a thread per core in each process makes every
    small op of the eager steps wait on the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _delta(rec, before, prefix: str) -> dict:
    return {k: v for k, v in rec.delta(before, rec.counts()).items()
            if k.startswith(prefix)}


def _bitwise(a, b) -> bool:
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the traced step counter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("data", [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_of_a_tensor_is_fold_in_of_its_int(data):
    keys = torch.stack([R.key(s) for s in (0, 7, 2 ** 32 - 1)])
    for k in (keys[0], keys):
        want = R.fold_in(k, data)
        for dt in (torch.int64,) + ((torch.int32,) if data < 2 ** 31 else ()):
            assert torch.equal(R.fold_in(k, torch.tensor(data, dtype=dt)),
                               want)
    jk = jax.random.key_data(jax.random.fold_in(jax.random.key(7), data))
    np.testing.assert_array_equal(
        R.fold_in(keys[1], torch.tensor(data)).numpy(),
        np.asarray(jk).astype(np.int64))


def test_dithered_payload_at_step_t_is_the_references():
    """The step's counter reaches the codec as its 0-d int32 tensor
    (`_round_idx` returns it, never read on the host); the dither and the
    keep mask it salts are bitwise the reference's, which traces its
    int32 step as well, at every step."""
    kw = STRATEGIES["dithered_keep"]
    jgc, tgc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    state = TO.adamw(LR).init({"x": torch.zeros(3)})
    assert TS._round_idx(state) is state["step"]
    u = np.random.default_rng(4).standard_normal((3, 1000)).astype(
        np.float32)
    step0 = jnp.zeros((), jnp.int32)
    jencode = jax.jit(lambda x, t: JG.encode_leaf(x, 5, jgc, t)).lower(
        jnp.asarray(u), step0).compile(compiler_options=UNFUSED)
    for t in range(3):
        state["step"].fill_(t)
        want = jencode(jnp.asarray(u), step0 + t)
        got = TG.encode_leaf(torch.from_numpy(u), 5, tgc,
                             TS._round_idx(state))
        assert set(got) == set(want) == {"words", "scale", "mask"}
        for k in want:
            np.testing.assert_array_equal(
                got[k].numpy().view(np.int32),
                np.asarray(want[k]).view(np.int32))


# ---------------------------------------------------------------------------
# specializations against the reference's
# ---------------------------------------------------------------------------
def _toy_params():
    rng = np.random.default_rng(0)
    return {"b": rng.standard_normal((8, 32)).astype(np.float32)}


def _jtoy_loss(p, batch):
    return jnp.mean((batch["x"] @ p["b"]) ** 2)


def _ttoy_loss(p, batch):
    return torch.mean((batch["x"] @ p["b"]) ** 2)


def _toy_traffic():
    rng = np.random.default_rng(1)
    return [{"x": rng.standard_normal((b, 8)).astype(np.float32)}
            for b in (2, 2, 2, 3)]


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_train_step_specializations_equal_the_references(strategy):
    kw = dict(STRATEGIES[strategy], chunk=32)
    jgc, tgc = JG.GradCompConfig(**kw), TG.GradCompConfig(**kw)
    params = _toy_params()
    traffic = _toy_traffic()

    before = jrecompile.counts()
    jopt = jadamw(jwarmup(LR, 1, 10), weight_decay=0.1)
    jstep = JS.make_train_step(jconfigs.get_reduced("yi-6b"), jopt, jgc,
                               make_host_mesh(data=1, model=1),
                               clip_norm=1.0, loss_fn=_jtoy_loss)
    # its state placed as the step returns it (P()): else it compiles the
    # first call once more, for the placement's spelling (module docstring)
    mesh = make_host_mesh(data=1, model=1)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jax.device_put(
        [jp, jopt.init(jp), jax.tree.map(
            lambda x: jnp.zeros((1,) + x.shape), jp) if jgc.uses_ef else {}],
        NamedSharding(mesh, P()))
    placed = [[x.sharding for x in jax.tree.leaves(jstate)]]
    for batch in traffic:
        *jstate, _ = jstep(*jstate, jax.tree.map(jnp.asarray, batch))
        placed.append([x.sharding for x in jax.tree.leaves(jstate)])
    want = _delta(jrecompile, before, "dist.")

    before = recompile.counts()
    topt = TO.adamw(TO.warmup_cosine(LR, 1, 10), weight_decay=0.1)
    tstep = TS.make_train_step(tconfigs.get_reduced("yi-6b"), topt, tgc,
                               clip_norm=1.0, loss_fn=_ttoy_loss)
    tp = convert.from_numpy(params)
    tstate = [tp, topt.init(tp), tree_lib.map(
        lambda x: torch.zeros((1,) + tuple(x.shape)), tp)
        if tgc.uses_ef else {}]
    for batch in traffic:
        *tstate, _ = tstep(*tstate, convert.from_numpy(batch))
    got = _delta(recompile, before, "dist.")

    assert got == want == {"dist.step": 2}   # one per batch shape
    assert all(p == placed[0] for p in placed)
    assert int(tstate[1]["step"]) == len(traffic)


def test_zero1_specializations_equal_the_references():
    jcfg = jconfigs.get_reduced("yi-6b")
    tcfg = tconfigs.get_reduced("yi-6b")
    jgc = JG.GradCompConfig(strategy="alltoall_zero1")
    tgc = TG.GradCompConfig(strategy="alltoall_zero1")
    x = np.random.default_rng(2).standard_normal((2, 4)).astype(np.float32)

    def jloss(p, b):
        return sum(jnp.mean(v) for v in jax.tree.leaves(p)) * jnp.mean(b)

    def tloss(p, b):
        return sum(torch.mean(v) for v in tree_lib.leaves(p)) * torch.mean(b)

    before = jrecompile.counts()
    mesh = make_host_mesh(data=1, model=1)
    jstep = JS.make_zero_train_step(jcfg, jadamw(LR), jgc, mesh,
                                    loss_fn=jloss)
    # zeros placed as init_zero_state places its state (its values do not
    # key a program), but the EF as the step returns it (P(), where
    # init_zero_state spells P("data", None, None)): else the first call
    # compiles twice
    owned, opt_state, ef = (
        jax.tree.map(lambda s: jax.device_put(
            jnp.zeros(s.shape, s.dtype), s.sharding), specs)
        for specs in JS.zero_state_specs(jcfg, jadamw(LR), jgc, mesh))
    jstate = [owned, opt_state, jax.device_put(ef, NamedSharding(mesh, P()))]
    placed = [[v.sharding for v in jax.tree.leaves(jstate)]]
    for _ in range(2):
        *jstate, _ = jstep(*jstate, jnp.asarray(x))
        placed.append([v.sharding for v in jax.tree.leaves(jstate)])
    want = _delta(jrecompile, before, "dist.")

    before = recompile.counts()
    tstep = TS.make_zero_train_step(tcfg, TO.adamw(LR), tgc, loss_fn=tloss)
    tstate = TS.init_zero_state(tcfg, TO.adamw(LR), tgc, device="cpu")
    for _ in range(2):
        *tstate, _ = tstep(*tstate, torch.from_numpy(x))
    got = _delta(recompile, before, "dist.")
    assert got == want == {"dist.step.zero1": 1}
    assert all(p == placed[0] for p in placed)


def _fed_paths(participants, rates) -> list:
    """Per round, {client: "cohort" | "scalar"}: a client runs in a cohort
    when another participant shares its rate (its codec spec)."""
    out = []
    for round_ in participants:
        counts = {}
        for c in round_:
            counts[rates[c]] = counts.get(rates[c], 0) + 1
        out.append({c: "cohort" if counts[rates[c]] > 1 else "scalar"
                    for c in round_})
    return out


def _federation(pkg, shards, lr):
    dim = shards[0]["a"].shape[1]
    kw = {"aggregator": "fedmem", "server_lr": 0.5}
    ccfg = dict(lr=lr, local_steps=2, batch_size=8)
    cfg = dict(num_rounds=FED_ROUNDS, participation=0.5, seed=FED_SEED)
    if pkg == "port":
        f = tfed.Federation(
            _tloss, {"x": torch.zeros(dim)},
            [tree_lib.map(torch.from_numpy, s) for s in shards],
            [tcodecs.make("ndsc", r, chunk=64) for r in FED_RATES],
            tfed.ClientConfig(**ccfg), tfed.ServerConfig(**kw), seed=0,
            device="cpu")
        return f, f.run(tfed.FedConfig(**cfg))
    f = jfed.Federation(
        _jloss, {"x": jnp.zeros(dim)},
        [jax.tree.map(jnp.asarray, s) for s in shards],
        [jcodecs.make("ndsc", r, chunk=64) for r in FED_RATES],
        jfed.ClientConfig(**ccfg), jfed.ServerConfig(**kw), seed=0)
    return f, f.run(jfed.FedConfig(**cfg))


@pytest.fixture(scope="module")
def fed_runs():
    shards, lr, _ = _problem(m=len(FED_RATES), dim=32, per_client=32)
    out = {}
    for pkg, rec in (("reference", jrecompile), ("port", recompile)):
        before = rec.counts()
        f, hist = _federation(pkg, shards, lr)
        out[pkg] = (f, hist, _delta(rec, before, "fed."))
    with graph.eager():
        before = recompile.counts()
        out["eager"] = _federation("port", shards, lr) + (
            _delta(recompile, before, "fed."),)
    return out


def test_federation_specializations_equal_the_references(fed_runs):
    _, jhist, want = fed_runs["reference"]
    _, thist, got = fed_runs["port"]
    assert thist["participants"] == jhist["participants"]
    assert thist["wire_bytes"] == jhist["wire_bytes"]
    paths = _fed_paths(thist["participants"], FED_RATES)
    kinds = {p for r in paths for p in r.values()}
    assert kinds == {"cohort", "scalar"}
    # no client runs the scalar round on a state a cohort returned (the
    # reference's extra specialization, module docstring)
    for c in range(len(FED_RATES)):
        seq = [r[c] for r in paths if c in r]
        if "cohort" in seq:
            assert "scalar" not in seq[seq.index("cohort"):], (c, seq)
    assert got == want
    assert set(got) == {"fed.round.scalar", "fed.round.cohort",
                        "fed.decode.scalar", "fed.decode.cohort",
                        "fed.aggregate.memory"}
    assert fed_runs["eager"][2] == {}


def test_federation_program_path_is_bitwise_eager(fed_runs):
    f, hist, _ = fed_runs["port"]
    e, ehist, _ = fed_runs["eager"]
    assert hist == ehist
    assert _bitwise(f.server, e.server)
    assert _bitwise(f.states, e.states)


# ---------------------------------------------------------------------------
# the Program's CPU path against graph.eager()
# ---------------------------------------------------------------------------
def _train(tcfg, kw, steps, captured: bool):
    """(state, metrics per step, the dist.* specializations it added)."""
    before = recompile.counts()
    gc = TG.GradCompConfig(**kw)
    opt = TO.adamw(TO.warmup_cosine(LR, 1, 10), weight_decay=0.1)
    step = TS.make_train_step(tcfg, opt, gc, clip_norm=1.0)
    state = TS.init_train_state(tcfg, opt, gc, device="cpu")
    rng = np.random.default_rng(9)
    metrics = []
    with contextlib.nullcontext() if captured else graph.eager():
        for _ in range(steps):
            toks = rng.integers(0, tcfg.vocab_size, (2, 17)).astype(np.int32)
            out = step(*state, {"tokens": torch.from_numpy(toks)})
            # the captured step returns the caller's state tensors
            assert all(a is b for a, b in zip(tree_lib.leaves(out[:3]),
                                              tree_lib.leaves(state)))
            metrics.append(out[3])
    return state, metrics, _delta(recompile, before, "dist.")


@pytest.mark.parametrize("strategy", ["allgather_ef", "dithered_keep"])
def test_train_step_program_path_is_bitwise_eager(strategy):
    tcfg = dataclasses.replace(tconfigs.get_reduced("yi-6b"), num_layers=1)
    kw = STRATEGIES[strategy]
    state, metrics, added = _train(tcfg, kw, 3, captured=True)
    assert added == {"dist.step": 1}
    estate, emetrics, added = _train(tcfg, kw, 3, captured=False)
    assert added == {}
    assert _bitwise(metrics, emetrics)
    assert _bitwise(state, estate)          # params, mu, nu, step, EF
    assert int(state[1]["step"]) == 3
    assert bool(state[2]) == (strategy == "allgather_ef")


def test_zero1_program_path_is_bitwise_eager():
    tcfg = dataclasses.replace(tconfigs.get_reduced("yi-6b"), num_layers=1)
    gc = TG.GradCompConfig(strategy="alltoall_zero1")
    opt = TO.adamw(LR, weight_decay=0.1)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 9)).astype(np.int32))
    runs = []
    for ctx in (contextlib.nullcontext(), graph.eager()):
        step = TS.make_zero_train_step(tcfg, opt, gc, clip_norm=1.0)
        state = TS.init_zero_state(tcfg, opt, gc, device="cpu")
        with ctx:
            metrics = [step(*state, {"tokens": toks})[3] for _ in range(2)]
        runs.append((state, metrics))
    assert _bitwise(runs[0], runs[1])
    assert math.isfinite(float(runs[0][1][-1]["loss"]))
