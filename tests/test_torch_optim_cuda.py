"""The optimizer's kernels (`csrc/optim.cu` through `kernels.ops`:
sum_squares, adamw_update, sgd_update) against the tree maps that
`repro_torch.optimizer.optim` ran before them, kept below as the oracle.

On the CPU (no marker) the three ops dispatch the plain route, and the
optimizers, `global_norm` and `clip_by_global_norm` give the tree maps'
bits. On the card (marked `cuda`; skips without a GPU and nvcc) the
updates are bitwise the tree maps' given the same clip scale, over leaf
lengths that leave a float4, a warp or a block partly filled, a leaf that
is not 16-byte aligned, f32, bf16 and f16, with and without a clip, a
constant lr and `warmup_cosine` over steps 1-3; the sum of squares is within 1e-6
of an f64 sum and repeats its bits; a captured clip + update replays the
eager call's bits. This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_optim_cuda.py
"""
import math

import pytest
import torch

from repro_torch import obs
from repro_torch import tree as tree_lib
from repro_torch.kernels import _build, ops
from repro_torch.optimizer import optim


# ---------------------------------------------------------------------------
# The tree maps as optimizer.optim ran them (the oracle)
# ---------------------------------------------------------------------------
def _tm_f32(v, like):
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _tm_lr_at(lr, step):
    return lr(step) if callable(lr) else _tm_f32(lr, step)


def tm_global_norm(tree):
    total = 0
    for x in tree_lib.leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def tm_clip(tree, scale):
    return tree_lib.map(lambda x: (x * scale).to(x.dtype), tree)


def tm_clip_by_global_norm(tree, max_norm):
    norm = tm_global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tm_clip(tree, scale), norm


def tm_adamw_update(lr, b1, b2, eps, weight_decay, grads, state, params):
    step = state["step"] + 1
    lr_t = _tm_lr_at(lr, step)
    mu = tree_lib.map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
    nu = tree_lib.map(lambda v, g: b2 * v + (1 - b2) * torch.square(
        g.float()), state["nu"], grads)
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(_tm_f32(b1, step), stepf)
    c2 = 1 - torch.pow(_tm_f32(b2, step), stepf)

    def upd(m, v, p):
        m_hat, v_hat = m / c1, v / c2
        u = -lr_t * (m_hat / (torch.sqrt(v_hat) + eps)
                     + weight_decay * p.float())
        return u.to(p.dtype)

    updates = tree_lib.map(upd, mu, nu, params)
    return updates, {"mu": mu, "nu": nu, "step": step}


def tm_sgd_update(lr, momentum, nesterov, grads, state, params):
    step = state["step"] + 1
    lr_t = _tm_lr_at(lr, step)
    if not momentum:
        updates = tree_lib.map(
            lambda g, p: (-lr_t * g.float()).to(p.dtype), grads, params)
        return updates, {"step": step}
    vel = tree_lib.map(lambda v, g: momentum * v + g.float(),
                       state["vel"], grads)
    if nesterov:
        updates = tree_lib.map(
            lambda v, g, p: (-lr_t * (momentum * v + g.float())
                             ).to(p.dtype), vel, grads, params)
    else:
        updates = tree_lib.map(lambda v, p: (-lr_t * v).to(p.dtype),
                               vel, params)
    return updates, {"step": step, "vel": vel}


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------
ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1}
SGD_MODES = {"plain": (0.0, False), "momentum": (0.9, False),
             "nesterov": (0.9, True)}
# (g dtype, p dtype): the moments and the velocity stay f32
DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16),
          "f16": (torch.float16, torch.float16),
          "f32_grad_bf16_param": (torch.float32, torch.bfloat16),
          "f32_grad_f16_param": (torch.float32, torch.float16)}
SCHEDULES = {"constant": lambda: 3e-4,
             "warmup_cosine": lambda: optim.warmup_cosine(1e-2, 2, 9)}


def _bits_equal(a, b) -> bool:
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _tree(lengths, dtype, dev, seed, unaligned=()):
    """{"l<i>": a leaf of lengths[i] values, N(0, 1) from the seed};
    the leaves named in `unaligned` start one element into a buffer, so
    their data is not 16-byte aligned."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, n in enumerate(lengths):
        x = torch.randn(n + 1, generator=g).to(dtype).to(dev)
        out[f"l{i}"] = x[1:] if i in unaligned else x[:n].clone()
    return out


def _run_steps(opt, tm_update, grads_of, params, clip):
    """Three steps of `opt` through ops (with the clip's scale passed in)
    and of the tree maps (the clipped tree built first), each from its
    own state: the per-step (updates, state) of both."""
    state_k, state_t = opt.init(params), opt.init(params)
    got, want = [], []
    for s in range(3):
        grads = grads_of(s)
        scale = None
        if clip:
            scale = optim.clip_scale(optim.global_norm(grads), 0.5)
        uk, state_k = opt.update(grads, state_k, params, scale=scale)
        gt = grads if scale is None else tm_clip(grads, scale)
        ut, state_t = tm_update(gt, state_t, params)
        got.append((uk, state_k))
        want.append((ut, state_t))
    return got, want


# ---------------------------------------------------------------------------
# CPU: the plain route, with the tree maps' bits
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_cpu_optimizers_dispatch_ref_with_the_tree_maps_bits(dtype):
    """AdamW (warmup_cosine, clipped) and SGD in its three modes over 3
    steps, the global norm and `clip_by_global_norm`'s tree and norm:
    bitwise the tree maps', every call of the three ops on path "ref"."""
    gdt, pdt = DTYPES[dtype]
    lengths = (1, 3, 37, 4097)
    params = _tree(lengths, pdt, "cpu", 0)
    grads_of = lambda s: _tree(lengths, gdt, "cpu", 10 + s)  # noqa: E731
    session = obs.enable()
    try:
        lr = optim.warmup_cosine(1e-2, 2, 9)
        opt = optim.adamw(lr, **ADAMW)
        got, want = _run_steps(
            opt, lambda g, s, p: tm_adamw_update(lr, **ADAMW, grads=g,
                                                 state=s, params=p),
            grads_of, params, clip=True)
        assert _bits_equal(got, want)
        for mode, (mom, nest) in SGD_MODES.items():
            opt = optim.sgd(0.1, momentum=mom, nesterov=nest)
            got, want = _run_steps(
                opt, lambda g, s, p, m=mom, n=nest: tm_sgd_update(
                    0.1, m, n, g, s, p), grads_of, params, clip=True)
            assert _bits_equal(got, want), mode
        g = grads_of(0)
        assert _bits_equal(optim.global_norm(g), tm_global_norm(g))
        assert _bits_equal(optim.clip_by_global_norm(g, 0.5),
                           tm_clip_by_global_norm(g, 0.5))
    finally:
        obs.disable()
    events = [e["attrs"] for e in session.memory_events()
              if e["name"] == "kernels.dispatch"]
    ops_seen = {e["op"] for e in events}
    assert ops_seen == {"sum_squares", "adamw_update", "sgd_update"}
    assert {e["path"] for e in events} == {"ref"}
    assert sum(ops.launch_counts()[k] for k in ops_seen) == 0
    costs = session.costs()["programs"]
    for op in ops_seen:
        assert all(s["available"] for s in
                   costs[f"kernels.{op}.ref"]["specializations"]), op


def test_cpu_zero_length_and_meta_leaves_take_the_plain_route():
    """meta tensors (the dry-run's) run the plain maps: shapes, no
    values; a 0-d leaf counts one value."""
    p = {"w": torch.empty(5, 3, device="meta"),
         "b": torch.empty((), device="meta")}
    opt = optim.adamw(1e-3, weight_decay=0.1)
    u, st = opt.update(p, opt.init(p), p, scale=torch.ones((), device="meta"))
    assert u["w"].shape == (5, 3) and st["mu"]["b"].device.type == "meta"
    assert optim.global_norm(p).device.type == "meta"
    x = {"a": torch.tensor(3.0), "b": torch.ones(0)}
    assert float(optim.global_norm(x)) == 3.0


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    try:
        _build._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


# 1 and 3: the tail alone; 4097: 1,024 float4 and a tail of one;
# 2^20 + 3: many blocks of the persistent grid, and a tail; the last
# leaf (4097 again) is made unaligned, and takes the scalar loop
LENGTHS = (1, 3, 4097, (1 << 20) + 3, 4097)
UNALIGNED = (4,)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_adamw_update_matches_the_tree_maps(cuda, dtype, clip,
                                                 schedule):
    gdt, pdt = DTYPES[dtype]
    lr = SCHEDULES[schedule]()
    params = _tree(LENGTHS, pdt, cuda, 0, unaligned=UNALIGNED)
    grads_of = lambda s: _tree(LENGTHS, gdt, cuda, 10 + s,  # noqa: E731
                               unaligned=UNALIGNED)
    opt = optim.adamw(lr, **ADAMW)
    ops.reset_launch_counts()
    got, want = _run_steps(
        opt, lambda g, s, p: tm_adamw_update(lr, **ADAMW, grads=g, state=s,
                                             params=p),
        grads_of, params, clip)
    torch.cuda.synchronize()
    assert ops.launch_counts()["adamw_update"] == 3 * len(LENGTHS)
    for s, (a, b) in enumerate(zip(got, want)):
        assert _bits_equal(a, b), f"step {s + 1}"


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", sorted(SGD_MODES))
def test_cuda_sgd_update_matches_the_tree_maps(cuda, mode, dtype, clip,
                                               schedule):
    gdt, pdt = DTYPES[dtype]
    lr = SCHEDULES[schedule]()
    mom, nest = SGD_MODES[mode]
    params = _tree(LENGTHS, pdt, cuda, 0, unaligned=UNALIGNED)
    grads_of = lambda s: _tree(LENGTHS, gdt, cuda, 10 + s,  # noqa: E731
                               unaligned=UNALIGNED)
    opt = optim.sgd(lr, momentum=mom, nesterov=nest)
    ops.reset_launch_counts()
    got, want = _run_steps(
        opt, lambda g, s, p: tm_sgd_update(lr, mom, nest, g, s, p),
        grads_of, params, clip)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sgd_update"] == 3 * len(LENGTHS)
    for s, (a, b) in enumerate(zip(got, want)):
        assert _bits_equal(a, b), f"step {s + 1}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f16"])
def test_cuda_sum_squares_is_close_to_f64_and_repeats(cuda, dtype):
    """Within 1e-6 of the f64 sum of the same values, the same bits on a
    second call; also over 70 leaves (two tile launches) and a tree of
    mixed dtypes."""
    dt = DTYPES[dtype][0]
    trees = [_tree(LENGTHS, dt, cuda, 3, unaligned=(1, 3)),
             _tree([37 * (i % 5) + 1 for i in range(70)], dt, cuda, 4,
                   unaligned=(7,)),
             {**_tree((5, 33000), torch.float32, cuda, 5),
              "h": _tree((70001,), torch.bfloat16, cuda, 6),
              "k": _tree((4099,), torch.float16, cuda, 7, unaligned=(0,))}]
    ops.reset_launch_counts()
    for tree in trees:
        leaves = tree_lib.leaves(tree)
        a = ops.sum_squares(leaves)
        b = ops.sum_squares(leaves)
        want = sum(torch.sum(x.double() ** 2) for x in leaves)
        assert a.dtype == torch.float32 and a.shape == ()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert abs(float(a) / float(want) - 1.0) < 1e-6
    assert ops.launch_counts()["sum_squares"] == 2 * len(trees)


@pytest.mark.cuda
def test_cuda_captured_clip_and_update_replays_the_eager_bits(cuda):
    """global_norm, clip_scale and AdamW's update as one captured
    Program: its replays give the eager call's norm, updates and state
    bitwise, and count the launches they replay (one sum_squares, one
    adamw_update a leaf)."""
    from repro_torch import graph

    params = _tree(LENGTHS, torch.float32, cuda, 0)
    grads = _tree(LENGTHS, torch.float32, cuda, 1)
    opt = optim.adamw(optim.warmup_cosine(1e-2, 2, 9), **ADAMW)
    state = opt.init(params)

    def step(params, state, grads):
        norm = optim.global_norm(grads)
        updates, new = opt.update(grads, state, params,
                                  scale=optim.clip_scale(norm, 0.5))
        return updates, new, norm

    with graph.eager():
        want = step(params, state, grads)
    prog = graph.Program(step, bound=("[0]", "[1]"))
    first = prog(params, state, grads)
    ops.reset_launch_counts()
    replays = [prog(params, state, grads) for _ in range(2)]
    torch.cuda.synchronize()
    assert len(prog.capture_s) == 1
    assert _bits_equal(first, want)
    for got in replays:
        assert _bits_equal(got, want)
    counts = ops.launch_counts()
    assert (counts["sum_squares"], counts["adamw_update"]) == (
        2, 2 * len(LENGTHS))


@pytest.mark.cuda
def test_cuda_optimizer_ops_dispatch_cuda_and_refuse(cuda):
    """Every call on the card is path "cuda"; a non-contiguous leaf, an
    f64 or int32 leaf, a host lr raise ValueError (counted as
    kernels.forced_error)."""
    x = torch.randn(64, 8, device=cuda)
    lr = torch.full((), 1e-3, device=cuda)
    one = torch.ones((), device=cuda)
    mu = torch.zeros_like(x)
    session = obs.enable()
    try:
        ops.sum_squares([x])
        ops.adamw_update(x, mu, mu, x, lr, one, one, None, **ADAMW)
        ops.sgd_update(x, mu, x, lr, one, momentum=0.9, nesterov=False)
        with pytest.raises(ValueError, match="contiguous"):
            ops.sum_squares([x.t()])
        with pytest.raises(ValueError, match="contiguous"):
            ops.adamw_update(x.t(), mu.t(), mu.t(), x.t(), lr, one, one,
                             None, **ADAMW)
        for dt in (torch.float64, torch.int32):
            with pytest.raises(ValueError, match="bfloat16 or float16"):
                ops.sum_squares([x.to(dt)])
            with pytest.raises(ValueError, match="bfloat16 or float16"):
                ops.sgd_update(x.to(dt), None, x, lr, momentum=0.0,
                               nesterov=False)
        with pytest.raises(ValueError, match="0-d float32"):
            ops.sgd_update(x, None, x, lr.cpu(), momentum=0.0,
                           nesterov=False)
        torch.cuda.synchronize()
    finally:
        obs.disable()
    events = session.memory_events()
    paths = {(e["attrs"]["op"], e["attrs"]["path"]) for e in events
             if e["name"] == "kernels.dispatch"}
    assert paths == {("sum_squares", "cuda"), ("adamw_update", "cuda"),
                     ("sgd_update", "cuda")}
    refused = [e for e in events if e["name"] == "kernels.forced_error"]
    assert len(refused) == 7
    assert not math.isnan(float(ops.sum_squares([x])))
