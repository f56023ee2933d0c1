"""The "model" axis of repro_torch.dist against repro.dist: placement, the
serve step as tensor parallelism, the train step at model > 1.

The multi-rank cases run in two spawns of gloo ranks on the CPU (4 ranks:
meshes (2, 2) and (1, 4); 2 ranks: (1, 2) and (2, 1)), as
tests/test_torch_dist.py spawns them: fresh interpreters running this
file's __main__, one thread each, importing only repro_torch, each rank
writing its results to an .npz. The reference runs in the pytest process
on conftest's 4 virtual CPU devices while the ranks work. Marked `slow`
(spawned processes); they run in tier-1 all the same.

Tolerances: greedy tokens equal everywhere. With the f32 cache, logits
against the port's one-worker step within LOGIT_TOL, 5e-6 absolute
(ROADMAP's gate; their scale is ~1): a row-split product sums the ranks'
partial products in gloo's order (measured ≤ 4.8e-7, printed). With the
8-bit NDSC cache, logits within CODE_LOGIT_TOL, 2e-5, a measured need: a
K/V value on a bin edge lands in the neighbouring code when its last bits
move (as tests/test_torch_decode.py allows), which moves the logits of
later steps by up to 1.17e-5 on these inputs: the port's one-worker step
against the reference's one-device step (1.16e-5 at the fourth and fifth
of the 8 steps), and the ranks at (1, 4) against the one-worker step;
the reference's own (1, 2) and (2, 2) programs stay within 4.8e-7 of its
one-device step. The train step at
(data 2, model 2) is bitwise the (data 2, model 1) step: the params are
gathered whole (exact) and the consensus runs over the data group.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
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
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import decode as TD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optimizer import optim as TO  # noqa: E402

LOGIT_TOL = 5e-6
CODE_LOGIT_TOL = 2e-5
B, PROMPT, GEN, MAX_SEQ = 4, 4, 4, 16
LR = 3e-4
SPAWN_TIMEOUT_S = 240.0
# (arch, data, model) served with the f32 cache from the port's seeded
# init in the ranks and held against the port's one-worker step; mixtral's
# and yi's wk at model 4 split a head in half
SEEDED = (("yi-6b", 1, 4), ("mixtral-8x22b", 1, 4), ("arctic-480b", 1, 2),
          ("hymba-1.5b", 1, 2), ("xlstm-350m", 1, 2), ("mixtral-8x22b", 2, 2),
          ("mixtral-8x22b", 2, 1))
LAYOUTS = ((1, 2), (1, 4), (2, 2))
# (arch, data, model) served with the 8-bit cache from the reference's
# params on the ranks and by the reference's GSPMD step on its mesh; at
# data 2 the MoE routing counts its capacity over the global batch
GSPMD = (("yi-6b", 1, 2), ("yi-6b", 2, 2), ("mixtral-8x22b", 2, 2))


def _serve_cfg(cfg):
    """The reduced config with the 8-bit NDSC cache where it has attention."""
    if cfg.block == "xlstm_pair":
        return cfg
    return dataclasses.replace(cfg, kv_quant_bits=8)


def _spec_of(cfg):
    return tree_lib.flatten(TM.param_shapes(cfg), is_leaf=TM.is_shape)[1]


def _jax_params(inp, arch, cfg):
    """The reference's params of `arch`, as the fixture stored them."""
    pre = f"{arch}/p"
    n = len([k for k in inp if k.startswith(pre)])
    return tree_lib.unflatten(_spec_of(cfg), [
        torch.from_numpy(inp[f"{pre}{i}"]) for i in range(n)])


def _greedy(step, params, state, prompt):
    """The prompt stepped through `step`, then GEN greedy tokens: (logits
    (PROMPT + GEN, b, V), tokens (b, GEN + 1))."""
    logits, toks = [], []
    for t in range(prompt.shape[1]):
        lg, state = step(params, state, prompt[:, t:t + 1])
        logits.append(lg)
    tok = TD.greedy_token(lg)
    for _ in range(GEN):
        toks.append(tok)
        lg, state = step(params, state, tok)
        logits.append(lg)
        tok = TD.greedy_token(lg)
    toks.append(tok)
    return torch.stack(logits), torch.cat(toks, 1)


# ---------------------------------------------------------------------------
# The ranks (this file run as a script)
# ---------------------------------------------------------------------------
def _rank_serve(mesh, cfg, params, prompt, out, tag):
    """Greedy run of this rank's slots; the collectives of one step."""
    data, d = TSH.num_workers(mesh), TSH.worker_index(mesh)
    rows = B // data
    state = TD.init_decode_state(cfg, rows, MAX_SEQ, device="cpu")
    step = TS.make_serve_step(cfg, mesh)
    TSH.reset_transport_counts()
    step(params, TD.init_decode_state(cfg, rows, MAX_SEQ, device="cpu"),
         prompt[d * rows:(d + 1) * rows, :1])
    counts = TSH.transport_counts()
    logits, toks = _greedy(step, params, state,
                           prompt[d * rows:(d + 1) * rows])
    out[f"{tag}/logits"] = logits.numpy()
    out[f"{tag}/tokens"] = toks.numpy()
    for kind in ("all_gather", "all_reduce"):
        out[f"{tag}/{kind}/calls"] = counts[kind]["calls"]
        out[f"{tag}/{kind}/bytes"] = counts[kind]["bytes"]


def _rank_train(mesh, inp, out, tag):
    cfg = tconfigs.get_reduced("yi-6b")
    opt = TO.adamw(TO.warmup_cosine(LR, 1, 10), weight_decay=0.1)
    gc = TG.GradCompConfig()
    state = TS.init_train_state(cfg, opt, gc, mesh, seed=0, device="cpu")
    specs = TS.train_state_specs(cfg, opt, gc, mesh)
    out[f"{tag}/specs_ok"] = all(
        a.local_shape(mesh) == tuple(b.shape)
        for sp, st in zip(specs, state)
        for a, b in zip(tree_lib.leaves(sp), tree_lib.leaves(st)))
    step = TS.make_train_step(cfg, opt, gc, mesh, clip_norm=1.0)
    for s in range(2):
        *state, met = step(*state, {"tokens": torch.from_numpy(
            inp[f"tok{s}"])})
        whole = TS.whole_train_state(cfg, mesh, state[0], state[1])
        for i, x in enumerate(tree_lib.leaves(whole)):
            out[f"{tag}/s{s}/x{i}"] = x.detach().numpy().copy()
        out[f"{tag}/s{s}/loss"] = float(met["loss"])


def _rank_main(rank: int, world: int, init: str, in_path: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    TMESH.init_workers(rank, world, init, device="cpu")
    inp = dict(np.load(in_path))
    out: dict = {}
    yi = _serve_cfg(tconfigs.get_reduced("yi-6b"))
    mixtral = _serve_cfg(tconfigs.get_reduced("mixtral-8x22b"))
    prompt = torch.from_numpy(inp["prompt"])
    layouts = ((2, 2), (1, 4)) if world == 4 else ((1, 2), (2, 1))
    try:
        for data, model in layouts:
            mesh = TMESH.make_host_group(data, model)
            tag = f"{data}x{model}"
            # the reference's params, cut to this rank's slices: yi at
            # every layout (at (2, 1) each data worker serves its slots
            # with no collective), mixtral where the GSPMD step runs too
            runs = [("yi", "yi-6b", yi)] + [
                ("mixtral-jax", a, mixtral) for a, d, m in GSPMD
                if a == "mixtral-8x22b" and (d, m) == (data, model)]
            for name, arch, cfg in runs:
                whole = _jax_params(inp, arch, cfg)
                params = TSH.ModelShard(whole, model,
                                        mesh.model_index if model > 1
                                        else 0).take_tree(whole)
                _rank_serve(mesh, cfg, params, prompt, out, f"{name}/{tag}")
            if data == 2:
                _rank_train(mesh, inp, out, f"train/{tag}")
            for arch, d, m in SEEDED:
                if (d, m) != (data, model):
                    continue
                cfg = tconfigs.get_reduced(arch)
                params, _ = TS.init_serve_state(cfg, mesh, B, MAX_SEQ,
                                                seed=0, device="cpu")
                _rank_serve(mesh, cfg, params, prompt, out, f"{arch}/{tag}")
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


def _reference_serve(jparams, prompt):
    """The reference's GSPMD serve step for each of GSPMD on its mesh,
    inputs placed per its serve_state_specs: {(arch, data, model):
    (logits, tokens)}. The programs are compiled in a thread pool."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.dist import step as JS
    from repro.launch.mesh import make_host_mesh
    from repro.models import decode as JD
    jobs = []
    for arch, data, model in GSPMD:
        jcfg = _serve_cfg(jconfigs.get_reduced(arch))
        mesh = make_host_mesh(data=data, model=model)
        ps, ss, ts = JS.serve_state_specs(jcfg, mesh, B, MAX_SEQ)
        place = lambda x, s: jax.device_put(  # noqa: E731
            x, jax.tree.map(lambda y: y.sharding, s))
        params = place(jparams[arch], ps)
        state = place(JD.init_decode_state(jcfg, B, MAX_SEQ), ss)
        tok_sharding = ts.sharding
        fn = JS.make_serve_step(jcfg, mesh)
        lowered = fn.lower(params, state, jax.device_put(
            jnp.zeros((B, 1), jnp.int32), tok_sharding))
        jobs.append(((arch, data, model), params, state, tok_sharding,
                     lowered))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        compiled = list(pool.map(lambda j: j[4].compile(), jobs))
    out = {}
    for (key, params, state, tsh, _), fn in zip(jobs, compiled):
        def step(p, s, t, fn=fn, tsh=tsh):
            lg, s = fn(p, s, jax.device_put(jnp.asarray(t.numpy()), tsh))
            return torch.from_numpy(np.asarray(lg)), s
        out[key] = _greedy(step, params, state, prompt)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results {world: [npz dict]}, reference {(arch, d, m):
    (logits, tokens)}, inputs)."""
    import jax
    from repro import configs as jconfigs
    from repro.models import model as JM
    jparams = {a: JM.init_params(jax.random.key(0), _serve_cfg(
        jconfigs.get_reduced(a))) for a in ("yi-6b", "mixtral-8x22b")}
    rng = np.random.default_rng(5)
    ycfg = tconfigs.get_reduced("yi-6b")
    inp = {f"{a}/p{i}": np.asarray(x) for a, p in jparams.items()
           for i, x in enumerate(jax.tree.leaves(p))}
    inp["prompt"] = rng.integers(0, ycfg.vocab_size,
                                 (B, PROMPT)).astype(np.int32)
    for s in range(2):
        inp[f"tok{s}"] = rng.integers(0, ycfg.vocab_size,
                                      (4, 17)).astype(np.int32)
    root = tmp_path_factory.mktemp("tp")
    in_path = str(root / "in.npz")
    np.savez(in_path, **inp)
    dirs = {w: root / f"out{w}" for w in (4, 2)}
    for d in dirs.values():
        d.mkdir()
    prompt = torch.from_numpy(inp["prompt"])
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(_spawn, w, in_path, str(dirs[w]))
                for w in (4, 2)}
        ref = _reference_serve(jparams, prompt)
        for w, fut in futs.items():
            for r, (rc, _, se) in enumerate(fut.result()):
                assert rc == 0, f"world {w} rank {r} rc={rc}:\n{se[-3000:]}"
    ranks = {w: [dict(np.load(dirs[w] / f"rank{r}.npz")) for r in range(w)]
             for w in (4, 2)}
    return ranks, ref, inp


def _rank_files(ranks, data, model):
    return ranks[data * model]


def _one_worker(cfg, params, prompt):
    return _greedy(TS.make_serve_step(cfg), params,
                   TD.init_decode_state(cfg, B, MAX_SEQ, device="cpu"),
                   prompt)


def _check_ranks(files, tag, data, model, logits, tokens, what,
                 tol=LOGIT_TOL):
    rows = B // data
    gap = 0.0
    for r, f in enumerate(files):
        d = r // model
        want_l = logits[:, d * rows:(d + 1) * rows].numpy()
        want_t = tokens[d * rows:(d + 1) * rows].numpy()
        np.testing.assert_array_equal(f[f"{tag}/tokens"], want_t)
        gap = max(gap, float(np.abs(f[f"{tag}/logits"] - want_l).max()))
    print(f"{tag} against {what}: max |Δlogit| {gap}")
    assert gap <= tol


@pytest.mark.slow
@pytest.mark.parametrize("data, model", [(1, 2), (2, 2)])
def test_serve_against_reference_gspmd(runs, data, model):
    """The reduced yi-6b (8-bit cache) on the ranks against the
    reference's make_serve_step on its mesh, the same JAX params: tokens
    equal, logits within CODE_LOGIT_TOL (module docstring)."""
    ranks, ref, _ = runs
    logits, tokens = ref[("yi-6b", data, model)]
    _check_ranks(_rank_files(ranks, data, model), f"yi/{data}x{model}", data,
                 model, logits, tokens, "the reference's GSPMD step",
                 CODE_LOGIT_TOL)


@pytest.mark.slow
def test_moe_serve_against_reference_gspmd(runs):
    """The reduced mixtral (8-bit cache) at (data 2, model 2) against the
    reference's GSPMD step, the same JAX params: its routing counts the
    capacity and the drops over the global batch, so the tokens are the
    reference's and the logits within CODE_LOGIT_TOL."""
    ranks, ref, _ = runs
    logits, tokens = ref[("mixtral-8x22b", 2, 2)]
    _check_ranks(_rank_files(ranks, 2, 2), "mixtral-jax/2x2", 2, 2, logits,
                 tokens, "the reference's GSPMD step", CODE_LOGIT_TOL)


@pytest.mark.slow
@pytest.mark.parametrize("data, model", LAYOUTS + ((2, 1),))
def test_serve_8bit_against_one_worker(runs, data, model):
    """The reduced yi-6b (8-bit cache, the JAX params) on the ranks against
    the port's one-worker serve step: tokens equal, logits within
    CODE_LOGIT_TOL (module docstring). At (2, 1) (a process group of data
    workers) each rank runs the one-worker program on its slots."""
    ranks, _, inp = runs
    cfg = _serve_cfg(tconfigs.get_reduced("yi-6b"))
    params = _jax_params(inp, "yi-6b", cfg)
    logits, tokens = _one_worker(cfg, params, torch.from_numpy(inp["prompt"]))
    _check_ranks(_rank_files(ranks, data, model), f"yi/{data}x{model}", data,
                 model, logits, tokens, "the one-worker step", CODE_LOGIT_TOL)


@pytest.mark.slow
@pytest.mark.parametrize("arch, data, model", SEEDED)
def test_serve_against_one_worker(runs, arch, data, model):
    """Every decoding family (f32 cache) on the ranks, its params drawn
    leaf by leaf from the seed (init_serve_state), against the port's
    one-worker serve step on the whole seeded init: tokens equal, logits
    within LOGIT_TOL."""
    ranks, _, inp = runs
    cfg = tconfigs.get_reduced(arch)
    logits, tokens = _one_worker(cfg, TM.init_params(0, cfg, "cpu"),
                                 torch.from_numpy(inp["prompt"]))
    _check_ranks(_rank_files(ranks, data, model), f"{arch}/{data}x{model}",
                 data, model, logits, tokens, "the one-worker step")


@pytest.mark.slow
def test_collectives_per_step_equal_the_dry_census(runs):
    """The collectives one rank's serve step made (transport_counts: calls
    and bytes) equal the dry-run's census of the same step on meta tensors
    (launch.dryrun.decode_census). yi-6b at (1, 2), (1, 4), (2, 2): the
    plan is 1 all-gather (q, k, v) per layer and 1 (the head), 1
    all-reduce (the embedding) and 2 per layer (wo, W_down); at (2, 1)
    none. The reduced mixtral at (2, 2) and (2, 1) also gathers each MoE
    layer's top-k choices over the data group."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    ranks, _, _ = runs
    yi = _serve_cfg(tconfigs.get_reduced("yi-6b"))
    mixtral = _serve_cfg(tconfigs.get_reduced("mixtral-8x22b"))
    f = _rank_files(ranks, 2, 1)[0]
    assert int(f["yi/2x1/all_gather/calls"]) == 0
    assert int(f["yi/2x1/all_reduce/calls"]) == 0
    for data, model in LAYOUTS:
        f = _rank_files(ranks, data, model)[0]
        assert int(f[f"yi/{data}x{model}/all_gather/calls"]) == (
            yi.num_layers + 1)
        assert int(f[f"yi/{data}x{model}/all_reduce/calls"]) == (
            1 + 2 * yi.num_layers)
    f = _rank_files(ranks, 2, 1)[0]
    assert int(f["mixtral-8x22b/2x1/all_gather/calls"]) == (
        mixtral.num_layers)
    runs_ = [(yi, f"yi/{d}x{m}", d, m) for d, m in LAYOUTS + ((2, 1),)]
    runs_ += [(mixtral, "mixtral-jax/2x2", 2, 2),
              (tconfigs.get_reduced("mixtral-8x22b"), "mixtral-8x22b/2x1",
               2, 1)]
    for cfg, tag, data, model in runs_:
        f = _rank_files(ranks, data, model)[0]
        census = dryrun.decode_census(
            cfg, InputShape("t", MAX_SEQ, B, "decode"),
            TSH.MeshLayout(("data", "model"), (data, model)))
        for kind, name in (("all_gather", "all-gather"),
                           ("all_reduce", "all-reduce")):
            want = census.get(name, {"count": 0, "operand_bytes": 0})
            assert want["count"] == int(f[f"{tag}/{kind}/calls"]), tag
            assert want["operand_bytes"] == int(f[f"{tag}/{kind}/bytes"])


@pytest.mark.slow
def test_train_step_model2_bitwise_model1(runs):
    """The reduced yi-6b, allgather_packed with EF, AdamW, clip 1.0, 2
    steps at (data 2, model 2): every rank's whole params and optimizer
    state bitwise the (data 2, model 1) run's; each rank held the
    train_state_specs' local shapes."""
    ranks, _, _ = runs
    base = ranks[2]
    for world, tag in ((4, "train/2x2"), (2, "train/2x1")):
        for f in ranks[world]:
            assert bool(f[f"{tag}/specs_ok"])
    keys = [k[len("train/2x1/"):] for k in base[0]
            if k.startswith("train/2x1/s")]
    assert keys
    for f in ranks[4]:
        for k in keys:
            np.testing.assert_array_equal(f[f"train/2x2/{k}"],
                                          base[0][f"train/2x1/{k}"])


# ---------------------------------------------------------------------------
# In-process: placement against the reference, the leaf-by-leaf init
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_shard_shapes_match_reference(arch):
    """Every leaf's per-rank shape from the port's serve_state_specs and
    train_state_specs equals the reference's shard_shape on conftest's
    CPU devices, at (data, model) (1, 2), (1, 4), (2, 2): params, AdamW
    state, EF, caches, pos and tokens (jax.eval_shape only)."""
    import jax
    from repro import configs as jconfigs
    from repro.dist import step as JS
    from repro.dist.gradcomp import GradCompConfig
    from repro.launch.mesh import make_host_mesh
    from repro.optimizer import adamw
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    gc = GradCompConfig()
    for data, model in LAYOUTS:
        mesh = make_host_mesh(data=data, model=model)
        layout = TSH.MeshLayout(("data", "model"), (data, model))
        pairs = [(JS.train_state_specs(jcfg, adamw(1e-4), gc, mesh),
                  TS.train_state_specs(tcfg, TO.adamw(1e-4),
                                       TG.GradCompConfig(), layout))]
        if tcfg.decode_supported:
            pairs.append((JS.serve_state_specs(jcfg, mesh, 8, 64),
                          TS.serve_state_specs(tcfg, layout, 8, 64)))
        for want, got in pairs:
            jl = jax.tree.leaves(want)
            tl = tree_lib.leaves(got)
            assert len(jl) == len(tl)
            for a, b in zip(jl, tl):
                assert b.local_shape(layout) == tuple(
                    a.sharding.shard_shape(a.shape)), (arch, data, model)


@pytest.mark.parametrize("arch, model", [("yi-6b", 2), ("mixtral-8x22b", 4),
                                         ("hymba-1.5b", 2),
                                         ("xlstm-350m", 4)])
def test_leaf_by_leaf_init_is_the_slice_of_the_whole(arch, model):
    """init_serve_state's params (each leaf drawn whole and cut at once)
    are bitwise the slices of the one-worker init, on every rank; a rank
    never holds the whole model."""
    cfg = tconfigs.get_reduced(arch)
    whole = TM.init_params(3, cfg, "cpu")
    for j in range(model):
        layout = TSH.HostMesh(("data", "model"), (1, model), rank=j)
        got, state = TS.init_serve_state(cfg, layout, 2, 8, seed=3,
                                         device="cpu")
        want = TSH.ModelShard(whole, model, j).take_tree(whole)
        gl, wl = tree_lib.leaves(got), tree_lib.leaves(want)
        assert len(gl) == len(wl)
        for a, b in zip(gl, wl):
            assert torch.equal(a, b)
        assert sum(x.numel() for x in gl) < TM.param_count(cfg)
        assert state.pos.shape == (2,)


def test_moe_serve_state_refuses_a_batch_the_data_axis_does_not_divide():
    """An MoE serve step at data > 1 routes the global batch gathered over
    the data group, so its state must split the batch over that axis: a
    batch of 3 at data 2 is refused, one of 4 gives each rank 2 slots."""
    cfg = tconfigs.get_reduced("mixtral-8x22b")
    layout = TSH.HostMesh(("data", "model"), (2, 2), rank=0)
    with pytest.raises(ValueError, match="routes the global batch"):
        TS.init_serve_state(cfg, layout, 3, 8, device="cpu")
    _, state = TS.init_serve_state(cfg, layout, 4, 8, device="cpu")
    assert state.pos.shape == (2,)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
               sys.argv[5])
