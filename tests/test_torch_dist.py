"""repro_torch.dist over m workers (sharding, zero, step) against repro.dist.

The port's workers are processes: the multi-worker cases run in two spawns
(4 and 2 gloo ranks on the CPU, a `file://` store, `torch.set_num_threads(1)`,
no `XLA_FLAGS`, importing only repro_torch), each running every case and
writing its rank's state to an .npz. The reference runs in the pytest
process on the 4 virtual CPU devices of tests/conftest.py while the ranks
work. Marked `slow` (spawned processes, like tests/test_zero.py); they run
in tier-1 all the same.

Bitwise against the reference at m ∈ {2, 4}: a linear loss Σ sum(p · b)
whose gradient is exactly the worker's batch row, so both packages see the
same gradients; sgd(1.0), no clip, two steps on a 12-leaf tree (a tiny
attn_mlp model: sizes not multiples of the chunk, three leaves under it).
`allgather_packed` with EF and `alltoall_zero1` (dense, keep 0.5, exact
keep): params and EF bitwise, ZeRO-1's owned rows mapped back with
`from_owned`. `psum` and `psum_decoded` are `all_reduce` sums in gloo's
order: within ALLREDUCE_ATOL. The model at m = 4 (reduced yi-6b, AdamW,
clip 1.0): loss and params within tests/test_torch_train.py's bounds.
"""
from __future__ import annotations

import concurrent.futures
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.dist import gradcomp as TG  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.dist import step as TS  # noqa: E402
from repro_torch.dist import zero as TZ  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optimizer import optim as TO  # noqa: E402

CHUNK, BITS = 64, 4
ALLREDUCE_ATOL = 1e-5     # |Δp| of psum / psum_decoded, gradients of O(1)
LOSS_ATOL = 1e-4          # the linear loss: ~15k products of O(0.02) summed
LR = 3e-4                 # the model case, as tests/test_torch_train.py
CASES = (("allgather_ef", "allgather_packed", {}),
         ("zero_dense", "alltoall_zero1", {}),
         ("zero_keep", "alltoall_zero1", {"keep_fraction": 0.5}),
         ("zero_exact", "alltoall_zero1", {"keep_fraction": 0.5,
                                           "exact_keep": True}),
         ("psum", "psum", {}),
         ("psum_decoded", "psum_decoded", {}))
# the cases each worker count runs: every case at m = 4, the all-gather and
# the dense ZeRO-1 at m = 2 (each reference program costs seconds of XLA
# compile)
CASES_AT = {4: tuple(c[0] for c in CASES),
            2: ("allgather_ef", "zero_dense")}
SPAWN_TIMEOUT_S = 240.0
# XLA's CPU backend always allows FMA contraction inside a fusion, and the
# reference's fused decode contracts the dequantize multiply into the first
# FWHT butterfly; with the fusion pass off each op rounds as written
UNFUSED = {"xla_disable_hlo_passes": "fusion", "xla_backend_optimization_level": 0}


def _tiny(model_config):
    """A 12-leaf attn_mlp tree of 36-wide layers: leaves of 36 values (under
    the chunk), 648, 1296, 2520 and 2304 (the last a whole 36 chunks)."""
    return model_config(name="tiny", num_layers=1, d_model=36, num_heads=2,
                        num_kv_heads=1, d_ff=70, vocab_size=50,
                        vocab_pad_multiple=16)


def _linear_loss(p, b):
    """Σ_leaf sum(p · b[0]): its gradient is the worker's batch row."""
    return sum(torch.sum(x * y[0]) for x, y in zip(tree_lib.leaves(p),
                                                   tree_lib.leaves(b)))


def _leaf_inputs(inp, prefix):
    n = sum(1 for k in inp.files if k.startswith(prefix))
    return [torch.from_numpy(inp[f"{prefix}{i}"]) for i in range(n)]


# ---------------------------------------------------------------------------
# The ranks (this file run as a script)
# ---------------------------------------------------------------------------
def _rank_consensus(group, inp, out, m, r):
    cfg = _tiny(TM.ModelConfig)
    spec = tree_lib.flatten(TM.param_shapes(cfg),
                            is_leaf=lambda s: isinstance(s, tuple))[1]
    p0 = _leaf_inputs(inp, "p")
    opt = TO.sgd(1.0)
    for tag, strategy, kw in CASES:
        if tag not in CASES_AT[m]:
            continue
        gc = TG.GradCompConfig(bits=BITS, chunk=CHUNK, strategy=strategy,
                               **kw)
        if strategy == "alltoall_zero1":
            def own(p):
                o = TZ.to_owned(p, CHUNK, m)
                rows = o.shape[0] // m
                return o[r * rows:(r + 1) * rows].clone()
            params = tree_lib.unflatten(spec, [own(p) for p in p0])
            ef = tree_lib.unflatten(spec, [torch.zeros(
                (1,) + tuple(TZ.to_owned(p, CHUNK, m).shape)) for p in p0])
            step = TS.make_zero_train_step(cfg, opt, gc, group,
                                           loss_fn=_linear_loss)
        else:
            params = tree_lib.unflatten(spec, [p.clone() for p in p0])
            ef = (tree_lib.unflatten(spec, [torch.zeros((1,) + p.shape)
                                            for p in p0])
                  if gc.uses_ef else {})
            step = TS.make_train_step(cfg, opt, gc, group,
                                      loss_fn=_linear_loss)
        state = (params, opt.init(params), ef)
        for s in range(2):
            batch = tree_lib.unflatten(spec, _leaf_inputs(inp, f"b{s}_"))
            *state, metrics = step(*state, batch)
            for i, x in enumerate(tree_lib.leaves(state[0])):
                out[f"{tag}/s{s}/p{i}"] = x.numpy().copy()
            for i, x in enumerate(tree_lib.leaves(state[2])):
                out[f"{tag}/s{s}/e{i}"] = x.numpy().copy()
            out[f"{tag}/s{s}/loss"] = float(metrics["loss"])


def _rank_model(group, inp, out):
    cfg = tconfigs.get_reduced("yi-6b")
    spec = tree_lib.flatten(TM.param_shapes(cfg),
                            is_leaf=lambda s: isinstance(s, tuple))[1]
    params = tree_lib.unflatten(spec, _leaf_inputs(inp, "yp"))
    opt = TO.adamw(TO.warmup_cosine(LR, 1, 10), weight_decay=0.1)
    gc = TG.GradCompConfig()
    ef = tree_lib.map(lambda p: torch.zeros((1,) + p.shape), params)
    step = TS.make_train_step(cfg, opt, gc, group, clip_norm=1.0)
    state = (params, opt.init(params), ef)
    for s in range(2):
        tokens = torch.from_numpy(inp[f"tok{s}"])
        *state, metrics = step(*state, {"tokens": tokens})
        for i, x in enumerate(tree_lib.leaves(state[0])):
            out[f"model/s{s}/p{i}"] = x.detach().numpy().copy()
        out[f"model/s{s}/loss"] = float(metrics["loss"])


def _rank_units(group, out, m):
    """Sharding helpers and the state specs, on this rank."""
    for b in range(1, 10):
        out[f"axes/{b}"] = len(TSH.data_axes_for(b, group))
        batch = {"x": torch.arange(b * 3).reshape(b, 3)}
        out[f"shard/{b}"] = TSH.shard_batch(batch, group)["x"].numpy()
    cfg = _tiny(TM.ModelConfig)
    opt = TO.adamw(1e-3)
    ok = True
    for strategy, specs_fn, init_fn in (
            ("allgather_packed", TS.train_state_specs, TS.init_train_state),
            ("alltoall_zero1", TS.zero_state_specs, TS.init_zero_state)):
        gc = TG.GradCompConfig(bits=BITS, chunk=CHUNK, strategy=strategy)
        specs = specs_fn(cfg, opt, gc, group)
        state = init_fn(cfg, opt, gc, group, seed=3, device="cpu")
        for sp, st in zip(specs, state):
            s_leaves = tree_lib.leaves(sp)
            t_leaves = tree_lib.leaves(st)
            ok &= len(s_leaves) == len(t_leaves) and all(
                a.local_shape(m) == tuple(b.shape) and a.dtype == b.dtype
                for a, b in zip(s_leaves, t_leaves))
    out["specs_ok"] = ok
    # every rank must derive the same params: a rank-dependent seed raises
    try:
        TS.init_train_state(cfg, opt, TG.GradCompConfig(), group,
                            seed=TSH.worker_index(group), device="cpu")
        out["mismatch_raised"] = False
    except ValueError as e:
        out["mismatch_raised"] = "different params" in str(e)


def _rank_main(rank: int, world: int, init: str, in_path: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    group, _ = TMESH.init_workers(rank, world, init, device="cpu")
    inp = np.load(in_path)
    out: dict = {}
    try:
        _rank_units(group, out, world)
        _rank_consensus(group, inp, out, world, rank)
        if world == 4:
            _rank_model(group, inp, out)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# The pytest side
# ---------------------------------------------------------------------------
def _spawn(world: int, in_path: str, out_dir: str) -> list:
    return TMESH.run_local_ranks(
        lambda r, init: [__file__, str(r), str(world), init, in_path,
                         out_dir],
        world, SPAWN_TIMEOUT_S)


def _reference(inputs, jcfg, ycfg):
    """The reference's runs on its 2- and 4-device CPU meshes: each step
    program lowered here, compiled in a thread pool (XLA compiles outside
    the interpreter lock), then run."""
    import jax
    import jax.numpy as jnp
    from repro.dist import step as JS
    from repro.dist.gradcomp import GradCompConfig
    from repro.launch.mesh import make_host_mesh
    from repro.optimizer import adamw, sgd, warmup_cosine

    def loss(p, b):
        return sum(jnp.sum(x * y[0]) for x, y in
                   zip(jax.tree.leaves(p), jax.tree.leaves(b)))

    jobs = []      # (key, state, batches, lowered, compiler options)
    treedef = jax.tree.structure(JS.model_lib.init_params(
        jax.random.key(0), jcfg))
    for m in (2, 4):
        mesh = make_host_mesh(data=m, model=1)
        batches = [jax.tree.unflatten(treedef, [
            jnp.asarray(inputs[m][f"b{s}_{i}"])
            for i in range(treedef.num_leaves)]) for s in range(2)]
        for tag, strategy, kw in CASES:
            if tag not in CASES_AT[m]:
                continue
            gc = GradCompConfig(bits=BITS, chunk=CHUNK, strategy=strategy,
                                **kw)
            opt = sgd(1.0)
            if strategy == "alltoall_zero1":
                state = JS.init_zero_state(jcfg, opt, gc, mesh)
                fn = JS.make_zero_train_step(jcfg, opt, gc, mesh,
                                             loss_fn=loss)
            else:
                state = JS.init_train_state(jcfg, opt, gc, mesh)
                fn = JS.make_train_step(jcfg, opt, gc, mesh, loss_fn=loss)
            # fusion off where the test is bitwise (module docstring)
            jobs.append(((m, tag), state, batches,
                         fn._jitted.lower(*state, batches[0]),
                         {} if strategy.startswith("psum") else UNFUSED))
    mesh = make_host_mesh(data=4, model=1)
    opt = adamw(warmup_cosine(LR, 1, 10), weight_decay=0.1)
    gc = GradCompConfig()
    fn = JS.make_train_step(ycfg, opt, gc, mesh, clip_norm=1.0)
    state = JS.init_train_state(ycfg, opt, gc, mesh, jax.random.key(0))
    batches = [{"tokens": jnp.asarray(inputs[4][f"tok{s}"])}
               for s in range(2)]
    jobs.append(((4, "model"), state, batches,
                 fn._jitted.lower(*state, batches[0]), {}))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        compiled = list(pool.map(
            lambda j: j[3].compile(compiler_options=j[4]), jobs))
    ref = {}
    for (key, state, batches, _, _), fn in zip(jobs, compiled):
        for s in range(2):
            *state, met = fn(*state, batches[s])
            ref[key + (s,)] = (
                [np.asarray(x) for x in jax.tree.leaves(state[0])],
                [np.asarray(x) for x in jax.tree.leaves(state[2])],
                float(met["loss"]))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({m: [rank npz, ...]}, reference results, inputs)."""
    import jax
    from repro import configs as jconfigs
    from repro.models import model as JM
    jcfg = _tiny(JM.ModelConfig)
    ycfg = jconfigs.get_reduced("yi-6b")
    p0 = [np.asarray(x) for x in jax.tree.leaves(
        JM.init_params(jax.random.key(0), jcfg))]
    yp = [np.asarray(x) for x in jax.tree.leaves(
        JM.init_params(jax.random.key(0), ycfg))]
    rng = np.random.default_rng(7)
    inputs, paths = {}, {}
    root = tmp_path_factory.mktemp("dist")
    for m in (2, 4):
        d = {f"p{i}": p for i, p in enumerate(p0)}
        for s in range(2):
            for i, p in enumerate(p0):
                d[f"b{s}_{i}"] = rng.standard_normal(
                    (m,) + p.shape).astype(np.float32)
        if m == 4:
            d.update({f"yp{i}": p for i, p in enumerate(yp)})
            for s in range(2):
                d[f"tok{s}"] = rng.integers(0, ycfg.vocab_size,
                                            (4, 17)).astype(np.int32)
        inputs[m] = d
        paths[m] = (str(root / f"in{m}.npz"), root / f"out{m}")
        np.savez(paths[m][0], **d)
        paths[m][1].mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {m: pool.submit(_spawn, m, paths[m][0], str(paths[m][1]))
                for m in (4, 2)}
        ref = _reference(inputs, jcfg, ycfg)
        for m, fut in futs.items():
            for r, (rc, so, se) in enumerate(fut.result()):
                assert rc == 0, f"m={m} rank {r} rc={rc}:\n{se[-3000:]}"
    ranks = {m: [dict(np.load(paths[m][1] / f"rank{r}.npz"))
                 for r in range(m)] for m in (2, 4)}
    return ranks, ref, inputs


def _owned_to_full(rank_files, tag, s, shapes):
    """Reassemble ZeRO-1's owned rows of every rank into the leaves."""
    out = []
    for i, shape in enumerate(shapes):
        owned = np.concatenate([f[f"{tag}/s{s}/p{i}"] for f in rank_files])
        out.append(owned.reshape(-1)[:int(np.prod(shape))].reshape(shape))
    return out


def _leaves_of(f, tag, s, kind, n):
    return [f[f"{tag}/s{s}/{kind}{i}"] for i in range(n)]


@pytest.mark.slow
@pytest.mark.parametrize("m, tag", [(4, "allgather_ef"), (4, "zero_dense"),
                                    (4, "zero_keep"), (4, "zero_exact"),
                                    (2, "allgather_ef"), (2, "zero_dense")])
def test_consensus_bitwise_with_reference(runs, m, tag):
    ranks, ref, inputs = runs
    shapes = [inputs[m][f"p{i}"].shape for i in range(12)]
    for s in range(2):
        rp, re, rloss = ref[(m, tag, s)]
        if tag.startswith("zero"):
            rp = [a.reshape(-1)[:int(np.prod(sh))].reshape(sh)
                  for a, sh in zip(rp, shapes)]
        for r, f in enumerate(ranks[m]):
            if tag.startswith("zero"):
                got = _owned_to_full(ranks[m], tag, s, shapes)
            else:
                got = _leaves_of(f, tag, s, "p", 12)
            for a, b in zip(rp, got):
                np.testing.assert_array_equal(b, a)
            # this rank's EF against the reference's worker row r
            for a, b in zip(re, _leaves_of(f, tag, s, "e", 12)):
                np.testing.assert_array_equal(b[0], a[r])
            # the loss sums ~15k products in each backend's order
            np.testing.assert_allclose(float(f[f"{tag}/s{s}/loss"]), rloss,
                                       rtol=1e-5, atol=LOSS_ATOL)


@pytest.mark.slow
@pytest.mark.parametrize("tag", ["psum", "psum_decoded"])
def test_allreduce_strategies_within_tolerance(runs, tag):
    ranks, ref, _ = runs
    m = 4
    for s in range(2):
        rp, _, rloss = ref[(m, tag, s)]
        for f in ranks[m]:
            for a, b in zip(rp, _leaves_of(f, tag, s, "p", 12)):
                np.testing.assert_allclose(b, a, rtol=0,
                                           atol=ALLREDUCE_ATOL)
            np.testing.assert_allclose(float(f[f"{tag}/s{s}/loss"]), rloss,
                                       rtol=1e-5, atol=LOSS_ATOL)


@pytest.mark.slow
def test_zero1_against_allgather_inside_the_port(runs):
    """m = 4: ZeRO-1 equals all-gather bitwise after one step; after two
    the EF residuals enter (the fused residual against u − decode): the
    gap is at most 1e-5. Every rank holds the same params."""
    ranks, _, inputs = runs
    files = ranks[4]
    shapes = [inputs[4][f"p{i}"].shape for i in range(12)]
    for s in range(2):
        ag = _leaves_of(files[0], "allgather_ef", s, "p", 12)
        for f in files[1:]:
            for a, b in zip(ag, _leaves_of(f, "allgather_ef", s, "p", 12)):
                np.testing.assert_array_equal(b, a)
        z = _owned_to_full(files, "zero_dense", s, shapes)
        gap = max(float(np.max(np.abs(a - b))) for a, b in zip(ag, z))
        print(f"zero1 vs allgather, step {s}: max |Δp| {gap}")
        if s == 0:
            assert gap == 0.0
        assert gap <= 1e-5


@pytest.mark.slow
def test_model_two_steps_at_four_workers(runs):
    """Reduced yi-6b, allgather_packed with EF at m = 4 against the
    reference's 4-device step: tests/test_torch_train.py's bounds, but for
    the share of coordinates off by > 1e-6, held at the first step only.
    At the second AdamW step one sequence per worker makes the update
    amplify rounding: on these inputs the reference against itself (XLA's
    fusion pass on and off) already differs by > 1e-6 in up to 16% of a
    leaf's coordinates; the port's share is printed."""
    ranks, ref, _ = runs
    for s in range(2):
        rp, _, rloss = ref[(4, "model", s)]
        f = ranks[4][0]
        np.testing.assert_allclose(float(f[f"model/s{s}/loss"]), rloss,
                                   rtol=1e-5)
        diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
            rp, _leaves_of(f, "model", s, "p", len(rp)))])
        print(f"model step {s}: max {diffs.max()} median {np.median(diffs)}"
              f" share > 1e-6 {np.mean(diffs > 1e-6)}")
        assert diffs.max() <= 3 * LR * (s + 1)
        assert np.median(diffs) <= 1e-7
        if s == 0:
            assert np.mean(diffs > 1e-6) <= 0.1
        for g in ranks[4][1:]:
            for a, b in zip(_leaves_of(f, "model", s, "p", len(rp)),
                            _leaves_of(g, "model", s, "p", len(rp))):
                np.testing.assert_array_equal(b, a)


@pytest.mark.slow
@pytest.mark.parametrize("m", [2, 4])
def test_sharding_helpers_and_specs_on_ranks(runs, m):
    from repro.dist.sharding import data_axes_for
    from repro.launch.mesh import make_host_mesh
    ranks, _, _ = runs
    mesh = make_host_mesh(data=m, model=1)
    for r, f in enumerate(ranks[m]):
        assert bool(f["specs_ok"])
        assert bool(f["mismatch_raised"])
        for b in range(1, 10):
            assert int(f[f"axes/{b}"]) == len(data_axes_for(b, mesh))
            x = np.arange(b * 3).reshape(b, 3)
            want = x[r * (b // m):(r + 1) * (b // m)] if b % m == 0 else x
            np.testing.assert_array_equal(f[f"shard/{b}"], want)


# ---------------------------------------------------------------------------
# In-process: helpers against the reference, one worker, the raises
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model_axis", [1, 2, 4])
def test_param_specs_match_reference(model_axis):
    import jax
    from repro import configs as jconfigs
    from repro.dist.sharding import param_specs
    from repro.models import model as JM
    cfg = jconfigs.get_reduced("yi-6b")
    jshapes = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), cfg))
    want = jax.tree.leaves(param_specs(jshapes, model_axis),
                           is_leaf=lambda x: isinstance(
                               x, jax.sharding.PartitionSpec))
    got = tree_lib.leaves(TSH.param_specs(
        TM.param_shapes(tconfigs.get_reduced("yi-6b")), model_axis),
        is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(p) for p in want] == got


def test_zero_layout_matches_reference():
    import jax.numpy as jnp
    from repro.dist import zero as JZ
    from repro.dist.sharding import padded_lanes
    rng = np.random.default_rng(1)
    for shape in [(100,), (64, 64), (1,), (25, 40), (3, 7, 11)]:
        for chunk, m in [(64, 4), (32, 3), (64, 8), (128, 2)]:
            assert TZ.leaf_layout(shape, chunk, m) == JZ.leaf_layout(
                shape, chunk, m)
            x = rng.standard_normal(shape).astype(np.float32)
            jo = np.asarray(JZ.to_owned(jnp.asarray(x), chunk, m))
            to = TZ.to_owned(torch.from_numpy(x), chunk, m)
            np.testing.assert_array_equal(to.numpy(), jo)
            size = int(np.prod(shape))
            np.testing.assert_array_equal(
                TZ.from_owned(to, size, shape, torch.float32).numpy(), x)
            np.testing.assert_array_equal(
                TZ.valid_mask(size, jo.shape[0], chunk).numpy(),
                np.asarray(JZ.valid_mask(size, jo.shape[0], chunk)))
    for n in range(0, 12):
        for axis in (1, 2, 3, 4):
            assert TSH.padded_lanes(n, axis) == padded_lanes(n, axis)
    with pytest.raises(ValueError, match="positive"):
        TSH.padded_lanes(3, 0)


@pytest.mark.parametrize("m", [2, 3, 4])
def test_fold_mean_matches_xla_mean(m):
    """The worker mean, folded left to right and divided by a tensor,
    against XLA's CPU reduce (`jnp.mean` under jit, as in the reference's
    step): bitwise."""
    import jax
    import jax.numpy as jnp
    x = (np.random.default_rng(m).standard_normal((m, 4099)) * 1e3
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda s: jnp.mean(s, axis=0))(x))
    np.testing.assert_array_equal(
        TSH.fold_mean(torch.from_numpy(x)).numpy(), want)


def test_one_worker_group_equals_no_group(tmp_path):
    """A gloo world of 1 (in this process) gives the step without a group
    bitwise, for allgather_packed and ZeRO-1."""
    import torch.distributed as dist
    cfg = _tiny(TM.ModelConfig)
    rng = np.random.default_rng(2)
    shapes = tree_lib.leaves(TM.param_shapes(cfg),
                             is_leaf=lambda s: isinstance(s, tuple))
    spec = tree_lib.flatten(TM.param_shapes(cfg),
                            is_leaf=lambda s: isinstance(s, tuple))[1]
    batches = [tree_lib.unflatten(spec, [torch.from_numpy(
        rng.standard_normal((1,) + s).astype(np.float32)) for s in shapes])
        for _ in range(2)]
    outs = {}
    group, _ = TMESH.init_workers(0, 1, f"file://{tmp_path}/store",
                                  device="cpu")
    try:
        assert TMESH.make_host_group(1, 1) is None
        for g in (None, group):
            for strategy in ("allgather_packed", "alltoall_zero1"):
                gc = TG.GradCompConfig(bits=BITS, chunk=CHUNK,
                                       strategy=strategy)
                opt = TO.sgd(1.0)
                if strategy == "alltoall_zero1":
                    state = TS.init_zero_state(cfg, opt, gc, g, seed=1,
                                               device="cpu")
                    fn = TS.make_zero_train_step(cfg, opt, gc, g,
                                                 loss_fn=_linear_loss)
                else:
                    state = TS.init_train_state(cfg, opt, gc, g, seed=1,
                                                device="cpu")
                    fn = TS.make_train_step(cfg, opt, gc, g,
                                            loss_fn=_linear_loss)
                for b in batches:
                    *state, met = fn(*state, b)
                outs[(g is None, strategy)] = tree_lib.leaves(
                    (state[0], state[2])) + [met["loss"]]
    finally:
        dist.destroy_process_group()
    for strategy in ("allgather_packed", "alltoall_zero1"):
        for a, b in zip(outs[(True, strategy)], outs[(False, strategy)]):
            assert torch.equal(a, b)


def test_raises():
    """The refusals that remain: a mesh of ranks needs torch.distributed
    initialized and axes >= 1; the production layout starts no ranks; a
    serve step takes no malformed mesh (the model axis itself is served,
    tests/test_torch_tensor_parallel.py)."""
    from repro_torch import fed as tfed
    with pytest.raises(RuntimeError, match="initialized"):
        TMESH.make_host_group(data=1, model=2)
    with pytest.raises(ValueError, match="axes must be"):
        TMESH.make_host_group(data=0, model=2)
    with pytest.raises(ValueError, match="torchrun"):
        TMESH.make_production_mesh(start_ranks=True)
    with pytest.raises(ValueError, match="use_cohorts"):
        tfed.Federation(lambda p, b: p["x"].sum(), {"x": torch.zeros(4)},
                        [{"a": torch.zeros(2, 4)}] * 2,
                        tfed.make("ndsc", 2.0, chunk=32), backend="mesh",
                        use_cohorts=False, device="cpu")
    with pytest.raises(ValueError, match="make_zero_train_step"):
        TS.make_train_step(tconfigs.get_reduced("yi-6b"), TO.sgd(0.1),
                           TG.GradCompConfig(strategy="alltoall_zero1"))
    with pytest.raises(ValueError, match="a serve step takes"):
        TS.make_serve_step(tconfigs.get_reduced("yi-6b"),
                           mesh=("cuda:0", "cuda:1"))
    with pytest.raises(ValueError, match="no ranks"):
        TS.make_serve_step(tconfigs.get_reduced("yi-6b"),
                           mesh=TMESH.make_production_mesh())


def test_state_specs_and_serve_specs_at_one_worker():
    """The StateSpec records against what init_* return at one worker, and
    the serve state's specs against init_decode_state."""
    from repro_torch.models import decode as TD
    cfg = _tiny(TM.ModelConfig)
    opt = TO.adamw(1e-3)
    for strategy, specs_fn, init_fn in (
            ("allgather_packed", TS.train_state_specs, TS.init_train_state),
            ("alltoall_zero1", TS.zero_state_specs, TS.init_zero_state),
            ("psum", TS.train_state_specs, TS.init_train_state)):
        gc = TG.GradCompConfig(bits=BITS, chunk=CHUNK, strategy=strategy)
        for sp, st in zip(specs_fn(cfg, opt, gc),
                          init_fn(cfg, opt, gc, seed=0, device="cpu")):
            s_leaves, t_leaves = tree_lib.leaves(sp), tree_lib.leaves(st)
            assert len(s_leaves) == len(t_leaves)
            for a, b in zip(s_leaves, t_leaves):
                assert a.local_shape(1) == tuple(b.shape)
                assert a.dtype == b.dtype
    params_s, state_s, tok_s = TS.serve_state_specs(cfg, None, 2, 16)
    state = TD.init_decode_state(cfg, 2, 16, device="cpu")
    for a, b in zip(tree_lib.leaves(state_s), tree_lib.leaves(state)):
        assert a.shape == tuple(b.shape) and a.dtype == b.dtype
    assert tok_s.shape == (2, 1)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
               sys.argv[5])
