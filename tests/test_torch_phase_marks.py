"""The measurement inside the port, on the CPU: the train steps' phase
marks (`kernels.marks`), the obs spans and labels on the profiler's
clock (`obs.core.label`), and the set-up seconds of a program's first
call (`graph.setup_seconds`).

On the CPU `mark` launches nothing, so the steps' calls of it are
recorded by a stand-in; the card's side (the marks in a profiled replay,
in order, and a step's outputs bitwise with and without them) is
`tests/test_torch_cuda.py -k phase_marks`."""
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch import graph
from repro_torch.dist import gradcomp as G
from repro_torch.dist import step as S
from repro_torch.kernels import _build
from repro_torch.kernels import marks
from repro_torch.obs import core as obs
from repro_torch.optimizer import optim

STEPS = {"psum": (S.make_train_step, S.init_train_state,
                  {"strategy": "psum", "error_feedback": False}),
         "allgather_ef": (S.make_train_step, S.init_train_state, {}),
         "zero1": (S.make_zero_train_step, S.init_zero_state,
                   {"strategy": "alltoall_zero1"})}


def _step(kind):
    """A captured-path train step of the reduced yi-6b (1 layer) on the
    CPU, its state and a batch."""
    make, init, kw = STEPS[kind]
    cfg = dataclasses.replace(configs.get_reduced("yi-6b"), num_layers=1)
    gc = G.GradCompConfig(**kw)
    opt = optim.adamw(3e-4, weight_decay=0.1)
    step = make(cfg, opt, gc, clip_norm=1.0)
    state = init(cfg, opt, gc, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32))
    return step, state, {"tokens": toks}


def _profiled_names(fn) -> set:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_train_steps_mark_the_phases_in_order(kind, monkeypatch):
    """Each call of a train step marks the six phases once each, in
    order, on the step's device; its first call adds to the set-up of
    the name it registers under, a later call adds nothing."""
    seen = []
    monkeypatch.setattr(marks, "mark",
                        lambda phase, like: seen.append((phase, like.device)))
    step, state, batch = _step(kind)
    name = step.program.name
    before = graph.setup_seconds(name)["first_run"]
    step(*state, batch)
    first = graph.setup_seconds(name)["first_run"]
    assert seen == [(p, torch.device("cpu")) for p in marks.PHASES]
    step(*state, batch)
    assert [p for p, _ in seen] == list(marks.PHASES) * 2
    assert name == ("dist.step.zero1" if kind == "zero1" else "dist.step")
    assert first > before and graph.setup_seconds(name)["first_run"] == first


def test_mark_on_the_cpu_builds_and_launches_nothing(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "library", no_build)
    for phase in marks.PHASES:
        marks.mark(phase, torch.zeros(2))
        marks.mark(phase, torch.empty(2, device="meta"))


def test_mark_kernels_follow_the_phase_order():
    """csrc/marks.cu launches PHASES[i]'s kernel for index i, then the
    sublayers' after them, under the names the readers look for."""
    src = (_build.CSRC / "marks.cu").read_text()
    cases = re.findall(r"case (\d+): (\w+)<<<1, 1, 0, stream>>>", src)
    every = marks.PHASES + marks.SUBPHASES
    assert [(int(i), k) for i, k in cases] == [
        (i, marks.kernel_name(p)) for i, p in enumerate(every)]
    for p in every:
        assert f'extern "C" __global__ void {marks.kernel_name(p)}()' in src
    assert "marks" in _build.SOURCES
    assert list(_build._SIGNATURES["marks"]) == ["repro_mark"]


@pytest.mark.parametrize("session", [False, True])
@pytest.mark.parametrize("kind", ["span", "label"])
def test_spans_and_labels_stand_in_the_profilers_trace(kind, session):
    """Under a running profiler both enter a record_function of their
    name; a label emits no obs event, a span its one."""
    o = obs.enable() if session else None
    try:
        def run():
            with getattr(obs, kind)("phase.marks.test"):
                torch.ones(3).add_(1)

        names = _profiled_names(run)
        events = [e for e in (o.memory_events() if o else [])
                  if e["name"] == "phase.marks.test"]
    finally:
        if o is not None:
            obs.disable()
    assert "phase.marks.test" in names
    assert len(events) == (1 if kind == "span" and session else 0)


@pytest.mark.parametrize("kind", ["span", "label"])
def test_without_session_or_profiler_nothing_is_made(kind):
    assert not obs.enabled()
    assert getattr(obs, kind)("phase.marks.test") is obs.NOOP_SPAN


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_a_step_labels_its_host_phases(kind):
    """The step's call is labelled with its name; the program's host
    phases with graph.*: the first run at the first call only."""
    step, state, batch = _step(kind)
    name = step.program.name
    first = _profiled_names(lambda: step(*state, batch))
    later = _profiled_names(lambda: step(*state, batch))
    host = {name, "graph.fill", "graph.realize"}
    assert host | {"graph.first_run"} <= first
    assert host <= later and "graph.first_run" not in later


def test_setup_seconds_one_first_run_per_specialization():
    """Each new specialization's first call adds its eager run; a later
    call of one adds nothing; on the CPU nothing is released or
    captured."""
    def body(x):
        return x * 2.0

    p = graph.Program(body, name="phase.marks.setup")
    assert graph.Program(body).name == body.__qualname__
    got = [graph.setup_seconds(p.name)]
    for shape in ((3,), (3,), (4,), (4,), (3,)):
        p(torch.ones(shape))
        got.append(graph.setup_seconds(p.name))
    runs = [g["first_run"] for g in got]
    assert runs[0] == 0.0
    assert runs[1] > runs[0] and runs[2] == runs[1]
    assert runs[3] > runs[2] and runs[4] == runs[5] == runs[3]
    assert all(g["release_cache"] == g["capture"] == 0.0 for g in got)
    assert set(got[-1]) == set(graph.SETUP_PIECES)
