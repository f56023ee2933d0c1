"""The paper's algorithms (repro_torch.core.optim), the democratic
embedding and the serve launcher's prefill as captured programs
(`repro_torch.graph.Program`), on the CPU: the program path against the
same code inside `graph.eager()`, bitwise.

On the CPU a Program runs its function eagerly on its static buffers, so
these tests hold what the card's graphs depend on: the carry bound and
written in place, the step index traced as a 0-d tensor, the KeyStack's
blocks refilled in place outside the step (across block boundaries), the
inlining of a Program called inside another, a graph entry per live
frame, and the key's device. Their card counterparts are the `cuda`
cases of tests/test_torch_cuda.py (`-k core_graphs`)."""
import gc

import numpy as np
import pytest
import torch

from repro_torch import graph
from repro_torch import random as R
from repro_torch.core import checks
from repro_torch.core import embeddings as TE
from repro_torch.core import optim as TO
from repro_torch.launch import serve as tlaunch


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def _same_trace(a: TO.Trace, b: TO.Trace) -> bool:
    return all(_same(x, y) for x, y in zip(a, b))


@pytest.fixture
def programs():
    """Every graph.Program made while the test runs."""
    with checks.recorded_programs() as made:
        yield made


@pytest.mark.parametrize("case", sorted(checks.CASES))
def test_algorithm_program_path_is_bitwise_eager(case, programs):
    """Each algorithm runs as one step Program (one specialization for all
    its steps) and gives x_final, x_avg and dist_history bitwise as the
    same steps inside graph.eager(); the history is finite."""
    got = checks.run(case, torch.device("cpu"))
    steps_programs = [p for p in programs if p.fn.__name__ == "step"]
    assert len(steps_programs) == 1
    assert steps_programs[0]._cache_size() == 1
    with graph.eager():
        want = checks.run(case, torch.device("cpu"))
    assert _same_trace(got, want)
    assert got.dist_history.shape == (checks.STEPS,)
    assert torch.isfinite(got.dist_history).all()


@pytest.mark.parametrize("case", ["dq_psgd_multiworker_ndsc_hadamard",
                                  "dq_psgd_rand50_1b",
                                  "dgd_def_sublinear_hadamard"])
def test_draw_blocks_refilled_across_boundaries(case, monkeypatch):
    """With blocks of a few steps (every draw crosses at least two block
    boundaries in 20 steps), the program path is bitwise the eager path
    and both are bitwise the run with one block for all steps."""
    cpu = torch.device("cpu")
    one_block = checks.run(case, cpu, steps=20)
    monkeypatch.setattr(R, "_DRAW_BLOCK", 64)     # blocks of 1 to 8 steps
    small = checks.run(case, cpu, steps=20)
    with graph.eager():
        small_eager = checks.run(case, cpu, steps=20)
    assert _same_trace(small, small_eager)
    assert _same_trace(small, one_block)


def test_step_index_draws_read_their_block_row(monkeypatch):
    """A step Program drawing under KeyStack.at(t) (t traced to a 0-d
    tensor) reads, for every t, the bits of a draw under key t alone; the
    driver's step(t) refills each block in place (same buffer) when t
    crosses into it."""
    monkeypatch.setattr(R, "_DRAW_BLOCK", 12)               # 3 steps of 4
    steps = 10
    keys = R.split(R.key(7), steps)
    stack = R.KeyStack(keys)
    out = torch.zeros(steps, 4, dtype=torch.int64)
    bits = torch.zeros(steps, 2, dtype=torch.int64)

    def step(out, bits, t):
        k = stack.at(t)
        out.index_copy_(0, t.reshape(1), R.random_bits32(k, (4,))[None])
        bits.index_copy_(0, t.reshape(1), R.split2(k)[1].value[None])

    program = graph.Program(step, bound=("[0]", "[1]"))
    buffers = set()
    for t in range(steps):
        stack.step(t)
        program(out, bits, t)
        buffers.update(b.buf.data_ptr() for b in stack._root._blocks)
    assert program._cache_size() == 1
    assert len(buffers) == len(stack._root._blocks) == 1
    for t in range(steps):
        assert torch.equal(out[t], R.random_bits32(keys[t], (4,)))
        assert torch.equal(bits[t], R.split2(keys[t])[1])


def test_nested_program_is_a_plain_call():
    """A Program called inside another's function records no
    specialization (and no graph entry) of its own; called alone it does.
    The democratic embedding inside a DGD-DEF step is such a call."""
    inner = graph.Program(lambda x: x * 2.0)
    outer = graph.Program(lambda x: inner(x) + 1.0)
    x = torch.arange(3.0)
    assert torch.equal(outer(x), x * 2.0 + 1.0)
    assert (outer._cache_size(), inner._cache_size(), inner.graphs()) == (
        1, 0, 0)
    inner(x)
    assert inner._cache_size() == 1
    before = TE._DEMOCRATIC._cache_size()
    checks.run("dgd_def_de_haar", torch.device("cpu"), steps=3)
    assert TE._DEMOCRATIC._cache_size() == before


@pytest.mark.parametrize("kind", ["hadamard", "haar"])
def test_democratic_program_is_bitwise_eager(kind):
    """Top-level democratic runs as a Program and gives the eager result
    bitwise, with y = S x to f32 precision."""
    frame, y = checks.democratic_case(kind, torch.device("cpu"))
    got = TE.democratic(frame, y)
    with graph.eager():
        want = TE.democratic(frame, y)
    assert _same(got, want)
    np.testing.assert_allclose(frame.apply(got).numpy(), y.numpy(), rtol=0,
                               atol=1e-4)


def test_democratic_graph_entry_per_live_frame():
    """One graph entry per live frame (a second call on the same frame
    reuses it), dropped when the frame dies."""
    cpu = torch.device("cpu")
    gc.collect()
    base = TE._DEMOCRATIC.graphs()
    f1, y = checks.democratic_case("hadamard", cpu)
    f2, _ = checks.democratic_case("haar", cpu)
    TE.democratic(f1, y)
    TE.democratic(f1, y * 2.0)
    assert TE._DEMOCRATIC.graphs() == base + 1
    TE.democratic(f2, y)
    assert TE._DEMOCRATIC.graphs() == base + 2
    del f1
    gc.collect()
    assert TE._DEMOCRATIC.graphs() == base + 1
    del f2
    gc.collect()
    assert TE._DEMOCRATIC.graphs() == base


def test_core_programs_are_not_registered():
    """As the reference registers no core program with obs.recompile, the
    names obs sees over a DGD-DEF (DE-Haar) run, an Alg. 3 run and a
    top-level democratic call are the names it saw before."""
    from repro_torch.obs import recompile
    before = set(recompile.counts())
    for case in ("dgd_def_de_haar", "dq_psgd_multiworker_ndsc_hadamard"):
        checks.run(case, torch.device("cpu"), steps=3)
    TE.democratic(*checks.democratic_case("haar", torch.device("cpu")))
    assert set(recompile.counts()) == before


def test_key_on_another_device_is_refused():
    """A key on another device than x0 raises, naming both devices."""
    grad = lambda x: x - 1.0                                    # noqa: E731
    frame, _ = checks.democratic_case("hadamard", torch.device("cpu"))
    codec = checks._codec(frame, 4.0)
    with pytest.raises(ValueError, match="meta.*cpu"):
        TO.dgd_def(grad, torch.zeros(checks.N), codec, 0.5, 3,
                   key=R.key(0, device="meta"))
    with pytest.raises(ValueError, match="meta.*cpu"):
        TO.dq_psgd(lambda k, x: x, torch.zeros(checks.N), None, 0.1, 3,
                   key=R.key(0, device="meta"))


def test_launcher_prefill_program_is_bitwise_eager(programs, capsys):
    """The launcher's tokens at --reduced --device cpu are the same through
    the prefill Program as inside graph.eager()."""
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "5", "--gen", "3"]
    got = tlaunch.main(argv)
    assert any(getattr(p.fn, "func", None) is tlaunch.decode_lib.prefill
               and p._cache_size() == 1 for p in programs)
    with graph.eager():
        want = tlaunch.main(argv)
    assert torch.equal(got, want)
    assert "prefill" in capsys.readouterr().out
