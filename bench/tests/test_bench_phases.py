"""The phase metrics on synthetic traced windows, and the set-up metrics
on seeded totals of the program."""
from __future__ import annotations

import pytest

import tiny
from bench import harness, phases, tracing
from repro_torch import graph
from repro_torch.kernels import marks

PHASE_METRICS = {"train_forward_ms": "forward",
                 "train_backward_ms": "backward",
                 "train_consensus_ms": "consensus",
                 "train_optimizer_ms": "optimizer",
                 "train_state_write_ms": "state_write"}
SETUP_METRICS = {"setup_first_run_s": "first_run",
                 "setup_release_cache_s": "release_cache",
                 "setup_capture_s": "capture"}


def _step_ops(t0: float, lengths: dict, inside=()) -> list:
    """One step's device operations from t0 (us): each phase's mark, then
    a kernel filling the rest of the phase's length; `inside` adds
    (phase, name, offset, dur) operations within a phase."""
    ops, t = [], t0
    for phase in marks.PHASES:
        ops.append((marks.kernel_name(phase), t, 2.0))
        if phase != "step_end":
            ops.append(("sm80_xmma_gemm_f32f32", t + 2.0,
                        lengths[phase] - 2.0))
            ops += [(name, t + off, dur) for p, name, off, dur in inside
                    if p == phase]
            t += lengths[phase]
    return sorted(ops, key=lambda o: o[1])


def _trace(ops: list, steps: int) -> tracing.Trace:
    return tracing.Trace(cell=tiny.cell("yi6b-train-ndsc"), steps=steps,
                         window_s=1.0, ops=ops, gaps=[], host={})


STEP1 = {"forward": 100.0, "backward": 300.0, "consensus": 50.0,
         "optimizer": 80.0, "state_write": 20.0}
STEP2 = {"forward": 120.0, "backward": 320.0, "consensus": 30.0,
         "optimizer": 60.0, "state_write": 40.0}


@pytest.mark.parametrize("name", sorted(PHASE_METRICS))
def test_two_steps_give_the_mean(name):
    ops = _step_ops(0.0, STEP1) + [("memcpy32_post", 580.0, 15.0)] \
        + _step_ops(1000.0, STEP2)
    got = harness.metric_reader(name).read(_trace(ops, 2))
    phase = PHASE_METRICS[name]
    assert got == pytest.approx((STEP1[phase] + STEP2[phase]) / 2 * 1e-3)


@pytest.mark.parametrize("fault", ["missing", "reordered", "extra_step",
                                   "one_step_counted"])
def test_a_broken_run_of_marks_gives_nothing(fault):
    one, two = _step_ops(0.0, STEP1), _step_ops(1000.0, STEP2)
    steps = 2
    if fault == "missing":
        two = [o for o in two if o[0] != marks.kernel_name("optimizer")]
    elif fault == "reordered":
        names = [o[0] for o in two]
        i, j = (names.index(marks.kernel_name(p))
                for p in ("consensus", "optimizer"))
        two[i], two[j] = (two[j][0],) + two[i][1:], (two[i][0],) + two[j][1:]
    elif fault == "extra_step":
        two += _step_ops(2000.0, STEP1)
    else:
        steps = 1
    t = _trace(one + two, steps)
    assert phases.mark_starts(t) is None
    for name in PHASE_METRICS:
        assert harness.metric_reader(name).read(t) is None


def test_no_marks_and_no_steps_give_nothing():
    ops = [o for o in _step_ops(0.0, STEP1) if "repro_mark" not in o[0]]
    assert harness.metric_reader("train_forward_ms").read(
        _trace(ops, 1)) is None
    assert harness.metric_reader("train_forward_ms").read(
        _trace(_step_ops(0.0, STEP1), 0)) is None


def test_a_codec_kernel_counts_to_the_consensus():
    """A codec kernel between the consensus and optimizer marks is the
    consensus's: the codec's metric reads it, and the consensus holds
    it with the glue around it."""
    ops = _step_ops(0.0, STEP1, inside=[
        ("consensus", "encode_row_kernel", 10.0, 12.0),
        ("consensus", "fwht_row_kernel", 30.0, 8.0)])
    t = _trace(ops, 1)
    codec = harness.metric_reader("codec_ms_per_step").read(t)
    consensus = harness.metric_reader("train_consensus_ms").read(t)
    assert codec == pytest.approx(20.0e-3)
    assert consensus == pytest.approx(STEP1["consensus"] * 1e-3)
    assert consensus >= codec
    assert harness.metric_reader("train_optimizer_ms").read(t) == \
        pytest.approx(STEP1["optimizer"] * 1e-3)


@pytest.mark.parametrize("name", sorted(SETUP_METRICS))
def test_setup_readers_read_the_programs_totals(name, monkeypatch):
    seeded = {"first_run": 9.25, "release_cache": 0.5, "capture": 1.75}
    asked = []

    def totals(program):
        asked.append(program)
        return dict(seeded)

    monkeypatch.setattr(graph, "setup_seconds", totals)
    t = _trace([], 1)
    assert harness.metric_reader(name).read(t) == seeded[SETUP_METRICS[name]]
    assert asked == ["dist.step"]
    monkeypatch.setattr(graph, "setup_seconds",
                        lambda program: dict.fromkeys(seeded, 0.0))
    assert harness.metric_reader(name).read(t) is None
    monkeypatch.delattr(graph, "setup_seconds")
    assert harness.metric_reader(name).read(t) is None
