"""repro_torch.fed.mesh: cohort lanes split over gloo ranks on the CPU.

Two spawns (2 and 4 ranks on a `file://` store, `torch.set_num_threads(1)`,
no `XLA_FLAGS`, importing only repro_torch) run every case; each rank
writes what it checked to an .npz. Marked `slow` (spawned processes); they
run in tier-1 all the same.

Inside the port, on every rank: `mesh_weighted_mean` in "sequential" mode
bitwise the single-process `aggregate_stacked` fold for lanes 2, 3, 6 and 8
(the reference's cases), "pairwise" within PAIRWISE_ATOL;
`Federation(backend="mesh")` against `backend="vmap"` with the ledger
byte-identical and params, optimizer state, server memory and client
states bitwise, for fedavg, fedopt and fedmem on a mixed population under
partial participation and stragglers, on an all-sub-linear population
(ledger == audit every round) and on one homogeneous cohort at full
participation (the single-cohort fast path).

Against the reference's `Federation(backend="mesh")` on its 4-device mesh
(run in the pytest process while the ranks work): fed_heterogeneous's
convex problem drawn in numpy (m 8, dim 128, norm-proportional budgets
around R̄ = 1, chunk 64), and the same problem at uniform budgets (one
8-lane cohort split over the ranks): ledger byte-identical, params within
tests/test_torch_fed.py's PARAM_TOL.
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

from repro_torch import codecs as tcodecs  # noqa: E402
from repro_torch import fed as tfed  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.fed import budget as tbudget  # noqa: E402
from repro_torch.fed import server as tserver  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.optimizer import optim as TO  # noqa: E402

PARAM_TOL = 1e-4          # max |Δx| / max |x|, as tests/test_torch_fed.py
PAIRWISE_ATOL = 1e-6      # pairwise vs sequential, f32 values of O(1)
HET_ROUNDS = 4
SPAWN_TIMEOUT_S = 240.0


def _het_problem(m=8, dim=128, per_client=256, seed=0):
    """fed_heterogeneous.make_problem's least squares, drawn in numpy (as
    tests/test_torch_fed.py draws it): (shards, lr = α*, probe norms)."""
    rng = np.random.default_rng(seed)
    scales = np.logspace(-1.0, 1.0, m)
    a = (rng.standard_normal((m, per_client, dim))
         / np.sqrt(per_client)).astype(np.float32)
    x_true = rng.standard_normal(dim).astype(np.float32)
    shards = [{"a": (scales[i] * a[i]).astype(np.float32),
               "b": (scales[i] * (a[i] @ x_true)).astype(np.float32)}
              for i in range(m)]
    all_a = np.concatenate([s["a"] for s in shards]).astype(np.float64)
    eigs = np.linalg.eigvalsh(all_a.T @ all_a / all_a.shape[0])
    norms = [float(np.linalg.norm(s["a"].astype(np.float64).T
                                  @ s["b"].astype(np.float64)) / per_client)
             for s in shards]
    return shards, float(2.0 / (eigs[-1] + eigs[0])), norms


def _het_rates(norms, uniform):
    if uniform:
        return np.ones(len(norms))
    return tbudget.allocate("norm_proportional", float(len(norms)),
                            len(norms), norms=norms, min_rate=0.25)


def _tloss(p, batch):
    r = batch["a"] @ p["x"] - batch["b"]
    return 0.5 * torch.mean(r * r)


def _mixed_population(seed=0):
    """m 6: a 3-lane ndsc cohort, a 2-lane sub-linear cohort and an identity
    singleton with a shorter shard: cohorts of 3 and 2 divide neither 2
    nor 4 ranks, so every mesh round pads."""
    rng = np.random.default_rng(seed)
    m, dim, n = 6, 48, 64
    a = (rng.standard_normal((m, n, dim)) / np.sqrt(n)).astype(np.float32)
    x_true = rng.standard_normal(dim).astype(np.float32)
    shards = [{"a": torch.from_numpy(a[i]),
               "b": torch.from_numpy(a[i] @ x_true)} for i in range(m)]
    shards[5] = {k: v[:32] for k, v in shards[5].items()}
    codecs = ([tcodecs.make("ndsc", 2.0, chunk=32) for _ in range(3)]
              + [tcodecs.make("ndsc", 0.75, chunk=32) for _ in range(2)]
              + [tcodecs.make("identity")])
    return shards, codecs, {"x": torch.zeros(dim)}


def _sublinear_population(seed=7):
    rng = np.random.default_rng(seed)
    m, dim, n = 5, 96, 24
    a = (rng.standard_normal((m, n, dim)) / np.sqrt(n)).astype(np.float32)
    x_true = rng.standard_normal(dim).astype(np.float32)
    shards = [{"a": torch.from_numpy(a[i]),
               "b": torch.from_numpy(a[i] @ x_true)} for i in range(m)]
    codecs = ([tcodecs.make("ndsc", 0.25, chunk=32) for _ in range(3)]
              + [tcodecs.make("ndsc", 0.5, chunk=32) for _ in range(2)])
    return shards, codecs, {"x": torch.zeros(dim)}


def _same(a, b) -> bool:
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _pair(group, shards, codecs, params, server_cfg, fed_cfg, ccfg):
    """(vmap Federation, history), (mesh Federation, history)."""
    out = []
    for backend in ("vmap", "mesh"):
        f = tfed.Federation(_tloss, params, shards, list(codecs), ccfg,
                            server_cfg, seed=3, backend=backend,
                            group=group if backend == "mesh" else None,
                            device="cpu")
        out.append((f, f.run(fed_cfg)))
    return out


def _bitwise_pair(pair) -> bool:
    (fv, hv), (fm, hm) = pair
    return (hv == hm and _same(fv.server, fm.server)
            and all(_same(a, b) for a, b in zip(fv.states, fm.states)))


# ---------------------------------------------------------------------------
# The ranks (this file run as a script)
# ---------------------------------------------------------------------------
def _rank_checks(group, out):
    # the collective fold against the single-process one
    for lanes in (2, 3, 6, 8):
        g = torch.Generator().manual_seed(lanes)
        stacked = {"w": torch.randn(lanes, 13, 5, generator=g),
                   "b": torch.randn(lanes, 29, generator=g)}
        w = np.random.default_rng(0).uniform(0.5, 2.0, lanes)
        ref = tserver._stacked_mean(stacked, w, "sequential")
        out[f"mean_seq/{lanes}"] = _same(
            ref, tfed.mesh_weighted_mean(stacked, w, group, "sequential"))
        got = tfed.mesh_weighted_mean(stacked, w, group, "pairwise")
        out[f"mean_pair/{lanes}"] = max(
            float((a - b).abs().max()) for a, b in zip(
                tree_lib.leaves(ref), tree_lib.leaves(got)))

    # the whole Federation: mixed population, partial participation,
    # stragglers
    ccfg = tfed.ClientConfig(local_steps=2, lr=0.3)
    fcfg = tfed.FedConfig(num_rounds=4, participation=0.8, dropout=0.2,
                          seed=9)
    for agg, scfg in (
            ("fedavg", tfed.ServerConfig()),
            ("fedopt", tfed.ServerConfig(aggregator="fedopt",
                                         optimizer=TO.sgd(1.0,
                                                          momentum=0.5))),
            ("fedmem", tfed.ServerConfig(aggregator="fedmem"))):
        pair = _pair(group, *_mixed_population(), scfg, fcfg, ccfg)
        out[f"mixed/{agg}"] = _bitwise_pair(pair)
        out[f"mixed/{agg}/stragglers"] = sum(
            len(s) for s in pair[1][1]["stragglers"])
    pair = _pair(group, *_mixed_population(),
                 tfed.ServerConfig(sum_mode="pairwise"),
                 tfed.FedConfig(num_rounds=3), ccfg)
    out["mixed/pairwise_gap"] = float(
        (pair[0][0].server.params["x"] - pair[1][0].server.params["x"])
        .abs().max())

    # all sub-linear budgets: the ledger equals the audit every round
    shards, codecs, params = _sublinear_population()
    pair = _pair(group, shards, codecs, params, tfed.ServerConfig(),
                 tfed.FedConfig(num_rounds=4, seed=13), ccfg)
    hist = pair[1][1]
    analytic = [c.wire_bits(params) / 8.0 for c in codecs]
    out["sublinear/bitwise"] = _bitwise_pair(pair)
    out["sublinear/ledger"] = all(
        hist["wire_bytes"][t] == hist["analytic_bytes"][t]
        == sum(analytic[i] for i in ps)
        for t, ps in enumerate(hist["participants"]))

    # one homogeneous cohort at full participation: the fast path
    shards, lr, _ = _het_problem(m=8, dim=64, per_client=32, seed=2)
    datas = [tree_lib.map(torch.from_numpy, s) for s in shards]
    codec = tcodecs.make("ndsc", 2.0, chunk=32)
    for agg in ("fedavg", "fedmem"):
        pair = _pair(group, datas, [codec] * 8, {"x": torch.zeros(64)},
                     tfed.ServerConfig(aggregator=agg),
                     tfed.FedConfig(num_rounds=3), tfed.ClientConfig(lr=lr))
        out[f"homog/{agg}"] = _bitwise_pair(pair)


def _rank_het(group, out):
    """fed_heterogeneous under the mesh backend, for the reference."""
    shards, lr, norms = _het_problem()
    datas = [tree_lib.map(torch.from_numpy, s) for s in shards]
    for uniform in (False, True):
        cs = [tcodecs.make("ndsc", float(r), chunk=64)
              for r in _het_rates(norms, uniform)]
        f = tfed.Federation(_tloss, {"x": torch.zeros(128)}, datas, cs,
                            tfed.ClientConfig(lr=lr), tfed.ServerConfig(),
                            seed=0, backend="mesh", group=group,
                            device="cpu")
        h = f.run(tfed.FedConfig(num_rounds=HET_ROUNDS, seed=0))
        tag = f"het/{int(uniform)}"
        out[f"{tag}/x"] = f.server.params["x"].numpy()
        out[f"{tag}/wire"] = np.asarray(h["wire_bytes"], np.float64)
        out[f"{tag}/analytic"] = np.asarray(h["analytic_bytes"], np.float64)


def _rank_main(rank: int, world: int, init: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    group, _ = TMESH.init_workers(rank, world, init, device="cpu")
    out: dict = {}
    try:
        _rank_checks(group, out)
        if world == 4:
            _rank_het(group, out)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# The pytest side
# ---------------------------------------------------------------------------
def _spawn(world: int, out_dir: str) -> list:
    return TMESH.run_local_ranks(
        lambda r, init: [__file__, str(r), str(world), init, out_dir],
        world, SPAWN_TIMEOUT_S)


def _reference_het():
    """The reference's mesh backend on its 4-device mesh, both budgets."""
    import jax
    import jax.numpy as jnp
    from repro import codecs as jcodecs
    from repro import fed as jfed
    from repro.launch.mesh import make_host_mesh

    def jloss(p, batch):
        r = batch["a"] @ p["x"] - batch["b"]
        return 0.5 * jnp.mean(r * r)

    shards, lr, norms = _het_problem()
    out = {}
    for uniform in (False, True):
        cs = [jcodecs.make("ndsc", float(r), chunk=64)
              for r in _het_rates(norms, uniform)]
        f = jfed.Federation(jloss, {"x": jnp.zeros(128)},
                            [jax.tree.map(jnp.asarray, s) for s in shards],
                            cs, jfed.ClientConfig(lr=lr),
                            jfed.ServerConfig(), seed=0, backend="mesh",
                            mesh=make_host_mesh(data=4, model=1))
        h = f.run(jfed.FedConfig(num_rounds=HET_ROUNDS, seed=0))
        out[uniform] = (np.asarray(f.server.params["x"]), h)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fed_mesh")
    dirs = {m: root / f"m{m}" for m in (2, 4)}
    for d in dirs.values():
        d.mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {m: pool.submit(_spawn, m, str(dirs[m])) for m in (4, 2)}
        ref = _reference_het()
        for m, fut in futs.items():
            for r, (rc, _, se) in enumerate(fut.result()):
                assert rc == 0, f"m={m} rank {r} rc={rc}:\n{se[-3000:]}"
    ranks = {m: [dict(np.load(dirs[m] / f"rank{r}.npz"))
                 for r in range(m)] for m in (2, 4)}
    return ranks, ref


@pytest.mark.slow
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("lanes", [2, 3, 6, 8])
def test_mesh_weighted_mean(runs, m, lanes):
    for f in runs[0][m]:
        assert bool(f[f"mean_seq/{lanes}"])
        assert float(f[f"mean_pair/{lanes}"]) <= PAIRWISE_ATOL


@pytest.mark.slow
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", ["mixed/fedavg", "mixed/fedopt",
                                  "mixed/fedmem", "sublinear/bitwise",
                                  "homog/fedavg", "homog/fedmem"])
def test_mesh_backend_bitwise_with_vmap(runs, m, case):
    for f in runs[0][m]:
        assert bool(f[case]), case
        if case.startswith("mixed"):
            assert int(f[case + "/stragglers"]) > 0


@pytest.mark.slow
@pytest.mark.parametrize("m", [2, 4])
def test_mesh_sublinear_ledger_and_pairwise(runs, m):
    for f in runs[0][m]:
        assert bool(f["sublinear/ledger"])
        assert float(f["mixed/pairwise_gap"]) <= PAIRWISE_ATOL


@pytest.mark.slow
@pytest.mark.parametrize("uniform", [False, True],
                         ids=["norm_proportional", "uniform_cohort"])
def test_mesh_backend_matches_the_reference(runs, uniform):
    ranks, ref = runs
    want, hist = ref[uniform]
    for f in ranks[4]:
        tag = f"het/{int(uniform)}"
        assert f[f"{tag}/wire"].tolist() == hist["wire_bytes"]
        assert f[f"{tag}/analytic"].tolist() == hist["analytic_bytes"]
        assert hist["wire_bytes"] == hist["analytic_bytes"]
        got = f[f"{tag}/x"]
        assert np.abs(got - want).max() <= PARAM_TOL * np.abs(want).max()
        np.testing.assert_array_equal(got, ranks[4][0][f"{tag}/x"])


def test_one_rank_mesh_is_vmap():
    """Without torch.distributed the mesh backend is one rank: bitwise the
    vmap backend, no padding."""
    ccfg = tfed.ClientConfig(local_steps=2, lr=0.3)
    pair = _pair(None, *_mixed_population(), tfed.ServerConfig(),
                 tfed.FedConfig(num_rounds=3, participation=0.8,
                                dropout=0.2, seed=9), ccfg)
    assert pair[1][0].group is None
    assert _bitwise_pair(pair)
    assert tfed.default_mesh() is None


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
