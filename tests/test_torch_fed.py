"""repro_torch.fed vs repro.fed on the CPU, and the port's own bitwise
contracts.

Against the reference (the same numpy inputs): the budget policies equal
to the last bit; on `benchmarks/fed_heterogeneous`'s convex problem (m 8,
dim 128, 256 examples per client, chunk 64, norm-proportional budgets
around R̄ = 1 with min rate 0.25), fedavg at full participation and fedmem
at 50% participation with 20% stragglers: participants and stragglers
identical, the ledger byte-identical round by round, params within
PARAM_TOL relative (the reference runs each round under `jit`, where XLA
turns divisions by constants into reciprocal multiplies and sums in its
own order, so a quantization bin may flip; error feedback keeps the gap
small).

Inside the port, bitwise: the cohort engine against the scalar path, and
the sequential stacked aggregate against the list aggregate. Pairwise
against sequential within PAIRWISE_ATOL (another summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codecs as jcodecs
from repro import fed as jfed
from repro.fed import budget as jbudget
from repro_torch import codecs as tcodecs
from repro_torch import fed as tfed
from repro_torch import random as R
from repro_torch import tree as tree_lib
from repro_torch.fed import budget as tbudget
from repro_torch.fed import server as tserver
from repro_torch.optimizer import optim as toptim

PARAM_TOL = 1e-4          # max |Δx| / max |x|, port against the reference
PAIRWISE_ATOL = 1e-6      # pairwise vs sequential, f32 deltas of O(1)


def _problem(m=8, dim=128, per_client=256, seed=0):
    """fed_heterogeneous.make_problem's least squares, drawn in numpy:
    per-client signal scales logspace(−1, 1)."""
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
    lr = float(2.0 / (eigs[-1] + eigs[0]))
    norms = [float(np.linalg.norm(s["a"].astype(np.float64).T
                                  @ s["b"].astype(np.float64)) / per_client)
             for s in shards]
    return shards, lr, norms


def _jloss(p, batch):
    r = batch["a"] @ p["x"] - batch["b"]
    return 0.5 * jnp.mean(r * r)


def _tloss(p, batch):
    r = batch["a"] @ p["x"] - batch["b"]
    return 0.5 * torch.mean(r * r)


def _run_both(shards, lr, rates, server_kw, fed_kw, rounds, adaptive=None):
    def fed_kwargs(pkg, codecs_):
        if adaptive is None:
            return {}
        return {"adaptive": pkg.AdaptiveConfig(**adaptive),
                "codec_factory": lambda r: codecs_.make("ndsc", float(r),
                                                        chunk=64)}

    jcs = [jcodecs.make("ndsc", float(r), chunk=64) for r in rates]
    tcs = [tcodecs.make("ndsc", float(r), chunk=64) for r in rates]
    dim = shards[0]["a"].shape[1]
    jf = jfed.Federation(_jloss, {"x": jnp.zeros(dim)},
                         [jax.tree.map(jnp.asarray, s) for s in shards],
                         jcs, jfed.ClientConfig(lr=lr),
                         jfed.ServerConfig(**server_kw), seed=0,
                         **fed_kwargs(jfed, jcodecs))
    tf = tfed.Federation(_tloss, {"x": torch.zeros(dim)},
                         [tree_lib.map(torch.from_numpy, s) for s in shards],
                         tcs, tfed.ClientConfig(lr=lr),
                         tfed.ServerConfig(**server_kw), seed=0,
                         device="cpu", **fed_kwargs(tfed, tcodecs))
    cfg_j = jfed.FedConfig(num_rounds=rounds, seed=0, **fed_kw)
    cfg_t = tfed.FedConfig(num_rounds=rounds, seed=0, **fed_kw)
    return jf.run(cfg_j), tf.run(cfg_t), jf, tf


@pytest.mark.parametrize("server_kw,fed_kw,adaptive", [
    ({}, {}, None),
    ({"aggregator": "fedmem", "server_lr": 0.25},
     {"participation": 0.5, "dropout": 0.2}, None),
    ({}, {}, {"total_rate": 8.0, "realloc_every": 2, "grid": 0.25}),
], ids=["fedavg", "fedmem-partial-stragglers", "adaptive-cohort"])
def test_federation_matches_the_reference(server_kw, fed_kw, adaptive):
    """The adaptive case starts from uniform budgets, so the 8 clients form
    one cohort (the reference's vmap, the port's lanes) until the first
    re-allocation splits them."""
    shards, lr, norms = _problem()
    rates = (np.ones(8) if adaptive else
             tbudget.allocate("norm_proportional", 8.0, 8, norms=norms,
                              min_rate=0.25))
    jh, th, jf, tf = _run_both(shards, lr, rates, server_kw, fed_kw, 6,
                               adaptive)
    for k in ("round", "participants", "stragglers", "realloc", "rates"):
        assert th[k] == jh[k], k
    assert th["wire_bytes"] == jh["wire_bytes"]
    assert th["analytic_bytes"] == jh["analytic_bytes"]
    assert th["wire_bytes"] == th["analytic_bytes"]
    if fed_kw:
        assert any(th["stragglers"])
    if adaptive:
        assert any(th["realloc"])
    want = np.asarray(jf.server.params["x"])
    got = tf.server.params["x"].numpy()
    assert np.abs(got - want).max() <= PARAM_TOL * np.abs(want).max()


def test_budget_policies_match_the_reference():
    norms = [0.3, 5.0, 1.2, 0.01, 2.5, 7.0]
    for policy in ("uniform", "norm_proportional", "waterfill"):
        np.testing.assert_array_equal(
            tbudget.allocate(policy, 9.0, 6, norms=norms, min_rate=0.25),
            jbudget.allocate(policy, 9.0, 6, norms=norms, min_rate=0.25))
    cfg = dict(total_rate=6.0, realloc_every=2, hysteresis=0.25, grid=0.25)
    tema, jema = tbudget.NormEMA(6, 0.6), jbudget.NormEMA(6, 0.6)
    for ids, vals in (([0, 2, 5], [1.0, 3.0, 0.5]), ([1, 2], [9.0, 0.1])):
        tema.update(ids, vals)
        jema.update(ids, vals)
    np.testing.assert_array_equal(tema.snapshot(), jema.snapshot())
    cur = np.ones(6)
    for policy in ("norm_proportional", "waterfill"):
        t = tbudget.reallocate(tbudget.AdaptiveConfig(policy=policy, **cfg),
                               tema, cur)
        j = jbudget.reallocate(jbudget.AdaptiveConfig(policy=policy, **cfg),
                               jema, cur)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1]
    tree = {"a": np.zeros((10, 3)), "b": np.zeros(50), "c": np.zeros(2)}
    assert (tbudget.split_leaf_budgets(tree, 2.0, norms=[1.0, 3.0, 0.2])
            == jbudget.split_leaf_budgets(tree, 2.0, norms=[1.0, 3.0, 0.2]))
    with pytest.raises(ValueError, match="feasible"):
        tbudget.allocate("uniform", 100.0, 2)


def test_local_sgd_minibatches_match_the_reference():
    """Mini-batch local SGD: the same randint rows under the same keys, so
    the same steps up to the gradient's summation order."""
    shards, lr, _ = _problem(m=1, dim=16, per_client=40)
    cfg = dict(local_steps=3, lr=lr, batch_size=8)
    k = jax.random.key(5)
    want = jfed.local_sgd(_jloss, {"x": jnp.ones(16)},
                          jax.tree.map(jnp.asarray, shards[0]), k,
                          jfed.ClientConfig(**cfg))
    got = tfed.local_sgd(_tloss, {"x": torch.ones(16)},
                         tree_lib.map(torch.from_numpy, shards[0]),
                         torch.from_numpy(np.asarray(jax.random.key_data(
                             k)).astype(np.int64)),
                         tfed.ClientConfig(**cfg))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-5, atol=1e-6)


def _same_tree(a, b):
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("codec_kw,server_kw,fed_kw", [
    (("ndsc", 1.5), {}, {}),
    (("ndsc", 0.5), {"aggregator": "fedmem", "server_lr": 0.25},
     {"participation": 0.5, "dropout": 0.2, "weighting": "data_size"}),
    (("ratq", 2.0), {"aggregator": "fedopt",
                     "optimizer": toptim.sgd(0.5, momentum=0.9)}, {}),
    (("sparsify_then_embed", 1.0), {}, {"participation": 0.75}),
    (("ndsc", 1.0), {"adaptive": {"total_rate": 6.0, "realloc_every": 2}},
     {}),
], ids=["ndsc-fedavg", "ndsc-fedmem-partial", "ratq-fedopt",
        "sparsify-partial", "ndsc-adaptive"])
def test_cohorts_equal_the_scalar_path_bitwise(codec_kw, server_kw, fed_kw):
    """One shared codec, so the participants form one cohort of lanes (until
    an adaptive re-allocation splits them); against use_cohorts=False
    (scalar rounds, list aggregate): params, EF, PRNG lanes and the ledger
    bit for bit."""
    shards, lr, _ = _problem(m=6, dim=64, per_client=16)
    name, budget = codec_kw
    server_kw = dict(server_kw)
    adaptive = server_kw.pop("adaptive", None)
    extra = {} if adaptive is None else {
        "adaptive": tfed.AdaptiveConfig(**adaptive),
        "codec_factory": lambda r: tcodecs.make(name, float(r), chunk=32)}
    runs = []
    for cohorts in (True, False):
        f = tfed.Federation(
            _tloss, {"x": torch.zeros(64)},
            [tree_lib.map(torch.from_numpy, s) for s in shards],
            tcodecs.make(name, budget, chunk=32),
            tfed.ClientConfig(lr=lr, local_steps=2, batch_size=8),
            tfed.ServerConfig(**server_kw), seed=3, use_cohorts=cohorts,
            device="cpu", **extra)
        h = f.run(tfed.FedConfig(num_rounds=4, seed=1, **fed_kw))
        runs.append((f, h))
    (fc, hc), (fs, hs) = runs
    assert hc == hs
    assert any(hc["realloc"]) == (adaptive is not None)
    _same_tree(fc.server, fs.server)
    for a, b in zip(fc.states, fs.states):
        _same_tree(a, b)


def test_cohort_round_launches_one_encode_per_leaf(monkeypatch):
    """A cohort's client round encodes every lane's leaf in one call of the
    fused encoder, and the server decodes the cohort in one call per leaf
    (here counted around the `ops` functions; on the card the wrappers'
    launch counts show the same)."""
    from repro_torch.kernels import ops
    calls = {"encode_ef": 0, "unpack_dequant": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    shards, lr, _ = _problem(m=5, dim=64, per_client=16)
    f = tfed.Federation(
        _tloss, {"x": torch.zeros(64), "y": torch.zeros(3)},
        [tree_lib.map(torch.from_numpy, s) for s in shards],
        tcodecs.make("ndsc", 2.0, chunk=32), tfed.ClientConfig(lr=lr),
        seed=0, device="cpu")
    f.run(tfed.FedConfig(num_rounds=2))
    assert calls == {"encode_ef": 2 * 2, "unpack_dequant": 2 * 2}


def _deltas(m, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": torch.from_numpy(rng.standard_normal((7, 5)).astype(
                np.float32)),
             "b": torch.from_numpy(rng.standard_normal(9).astype(
                 np.float32))} for _ in range(m)]


@pytest.mark.parametrize("aggregator", ["fedavg", "fedopt", "fedmem"])
def test_stacked_aggregate_equals_the_list_aggregate(aggregator):
    m = 7
    deltas = _deltas(m)
    params = {"w": torch.ones(7, 5), "b": torch.zeros(9)}
    opt = (toptim.adamw(0.1) if aggregator == "fedopt" else None)
    ids = [0, 2, 3, 5, 8, 9, 11]
    w = np.array([1.0, 3.0, 2.0, 0.5, 1.0, 4.0, 2.5])
    slot_w = np.arange(1.0, 13.0)
    outs = {}
    for mode in ("sequential", "pairwise"):
        cfg = tserver.ServerConfig(aggregator, server_lr=0.5, optimizer=opt,
                                   sum_mode=mode)
        st = tserver.init_server(params, cfg, 12)
        ref = tserver.aggregate(st, cfg, deltas, w, ids,
                                slot_weights=slot_w)
        got = tserver.aggregate_stacked(st, cfg, tfed.stack_trees(deltas), w,
                                        ids, slot_weights=slot_w)
        outs[mode] = (ref, got)
    ref, seq = outs["sequential"]
    _same_tree(ref, seq)
    _, pair = outs["pairwise"]
    for a, b in zip(tree_lib.leaves(seq.params), tree_lib.leaves(pair.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                   atol=PAIRWISE_ATOL)


@pytest.mark.parametrize("mode", ["sequential", "pairwise"])
def test_zero_weight_padding_lanes_are_inert(mode):
    """Lanes of weight 0 (a cohort padded with copies of lane 0) change
    nothing: bitwise in sequential mode, within PAIRWISE_ATOL in pairwise
    mode (padding moves the pairs)."""
    deltas = _deltas(5, seed=1)
    padded = deltas + [deltas[0]] * 3
    params = {"w": torch.zeros(7, 5), "b": torch.zeros(9)}
    cfg = tserver.ServerConfig(sum_mode=mode)
    st = tserver.init_server(params, cfg, 5)
    a = tserver.aggregate_stacked(st, cfg, tfed.stack_trees(deltas),
                                  np.ones(5))
    b = tserver.aggregate_stacked(st, cfg, tfed.stack_trees(padded),
                                  np.r_[np.ones(5), np.zeros(3)])
    if mode == "sequential":
        _same_tree(a, b)
    for x, y in zip(tree_lib.leaves(a.params), tree_lib.leaves(b.params)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0,
                                   atol=PAIRWISE_ATOL)
    with pytest.raises(ValueError, match="non-negative"):
        tserver.aggregate_stacked(st, cfg, tfed.stack_trees(deltas),
                                  np.r_[np.ones(4), -1.0])
    with pytest.raises(ValueError, match="weights for"):
        tserver.aggregate_stacked(st, cfg, tfed.stack_trees(deltas),
                                  np.ones(4))


def test_backends_and_api():
    shards, lr, _ = _problem(m=2, dim=8, per_client=4)
    datas = [tree_lib.map(torch.from_numpy, s) for s in shards]
    codec = tcodecs.make("ndsc", 2.0, chunk=32)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        tfed.Federation(_tloss, {"x": torch.zeros(8)}, datas, codec,
                        backend="mesh", device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        tfed.Federation(_tloss, {"x": torch.zeros(8)}, datas, codec,
                        backend="pmap", device="cpu")
    assert set(tfed.__all__) == set(jfed.__all__) - {
        "aggregate_stacked_mesh", "default_mesh", "make_mesh_cohort_round",
        "mesh_weighted_mean"}
    with pytest.warns(DeprecationWarning, match="repro_torch.codecs"):
        tfed.registry.make("ndsc", 1.0)
    assert tfed.partition_cohorts([(0, "a"), (1, None), (2, "a"),
                                   (3, "b")]) == [("a", [0, 2]), ("b", [3]),
                                                  (None, [1])]


def test_tree_keeps_namedtuples_none_and_payload_subtrees():
    st = tfed.init_client_state({"x": torch.zeros(3)}, R.key(1))
    leaves, spec = tree_lib.flatten(st)
    back = tree_lib.unflatten(spec, leaves)
    assert type(back) is tfed.ClientState and torch.equal(back.key, st.key)
    assert jax.tree.structure(st).num_leaves == len(leaves)
    t = {"a": None, "b": (torch.ones(2), None), "c": [torch.zeros(1)]}
    assert len(tree_lib.leaves(t)) == len(jax.tree.leaves(t)) == 2
    assert tree_lib.unflatten(tree_lib.flatten(t)[1],
                              tree_lib.leaves(t))["a"] is None
    wire = {"a": None, "b": ({"words": 1, "scale": 2}, None),
            "c": [{"words": 3}]}
    assert tree_lib.flatten_up_to(tree_lib.flatten(t)[1], wire) == [
        {"words": 1, "scale": 2}, {"words": 3}]
    with pytest.raises(ValueError):
        tree_lib.flatten_up_to(tree_lib.flatten(t)[1], {"a": None})
