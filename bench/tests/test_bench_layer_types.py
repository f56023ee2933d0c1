"""The cell `mellum2-train-ndsc-s8k` (mode `train_layer_types`) on the CPU
at a toy width: its files are found by name; a sound run is correct, and
the control (the reference at TF32 products, emulated by rounding their
operands) and each planted fault are not, under the limits set on the
card; the sublayer metrics read the forward's marks alone; the steps of
`bench.reference.steps` are those of the one-model reference."""
from __future__ import annotations

import copy
import time

import pytest
import torch

import tiny
from bench import harness, run, sublayers, tracing, weights
from bench import train as one
from bench import train_layer_types as tl
from bench.reference import layer_types as ref_model
from bench.reference import model as ref_base
from bench.reference import steps as ref_steps
from bench.reference import train as reference
from repro_torch.kernels import marks

CPU = torch.device("cpu")
MELLUM = "mellum2-train-ndsc-s8k"


def mellum_cell() -> dict:
    """One period of layers at a toy width, 8 experts top-4, a window of
    24 inside a row of 96 tokens, YaRN from 32 positions."""
    c = harness.cell(MELLUM)
    cfg = dict(c["cfg"], hidden_size=64, head_dim=16, num_attention_heads=4,
               num_key_value_heads=2, moe_intermediate_size=32,
               num_experts=8, num_experts_per_tok=4, vocab_size=256,
               sliding_window=24)
    rope = copy.deepcopy(cfg["rope_parameters"])
    rope["full_attention"]["original_max_position_embeddings"] = 32
    c["cfg"] = dict(cfg, rope_parameters=rope)
    c["mix"] = dict(c["mix"], batch=1, seq=96)
    return c


@pytest.mark.parametrize("name,chips,mode", [
    (MELLUM, 1, "train_layer_types")])
def test_new_cells_are_found_by_name(name, chips, mode):
    c = harness.cell(name)
    assert set(c["limits"]) == tiny.LIMITS
    assert c["cfg"]["name"] == c["config"] and c["chips"] == chips
    assert c["mix"]["mode"] == mode
    assert (tiny.ROOT / "bench" / f"{mode}.py").exists()
    assert harness.load_json(tiny.ROOT / "bench" / "workloads"
                             / f"{name}.json")["set_from"] != "pending"


def test_the_file_keeps_the_published_keys():
    """The catalog's numbers under their own names; the program's widths
    come from the weights view."""
    cfg = harness.cell(MELLUM)["cfg"]
    assert (cfg["intermediate_size"], cfg["moe_intermediate_size"],
            cfg["num_experts"], cfg["num_experts_per_tok"]) == (
                7168, 896, 64, 8)
    view = tl.weights_cfg(cfg)
    assert (view["intermediate_size"], view["num_local_experts"]) == (896, 64)
    mcfg = tl.model_config(view)
    assert mcfg.layer_types == ("sliding",) * 3 + ("full",)
    assert mcfg.layer_rope(3).factor == 16.0 and mcfg.window == 1024
    from bench import weights

    assert weights.param_count(view) == 2_123_976_960


def test_sound_run_is_correct():
    done = run.execute(mellum_cell(), 2 ** 35 + 1, 0.2, False, CPU,
                       time.perf_counter())
    assert done["out"]["correct"], done["out"]["gaps"]


def test_control_is_not_correct():
    c = mellum_cell()
    ok, _ = harness.judge(tl.control_gaps(c, 11, CPU), c["limits"])
    assert not ok


@pytest.mark.parametrize("fault", tl.FAULTS)
def test_planted_fault_is_not_correct(fault):
    done = run.execute(mellum_cell(), 2 ** 35 + 1, 0.2, False, CPU,
                       time.perf_counter(), fault)
    assert done["out"]["correct"] is False, done["out"]["gaps"]


def test_the_cell_bounds_followed_flips_by_step():
    limits = tl.flip_limits(harness.cell(MELLUM))
    assert len(limits) == one.CHECKED_STEPS
    assert all(isinstance(n, int) and n > 0 for n in limits)
    assert tl.flip_limits(dict(harness.cell(MELLUM), name="none")) is None


def test_flips_past_a_step_limit_are_a_routing_fault():
    """The reference follows its own recorded choices but for 5 tokens of
    the second step's last layer, given another expert in place of their
    k-th: 5 followed flips that step (no layer after the last one routes
    on them) and none in the first, one fault under a limit of 4 on the
    second step and 0 on the first."""
    c = mellum_cell()
    cfg, mix = tl.weights_cfg(c["cfg"]), c["mix"]
    batches = weights.token_rows(cfg, 11, one.CHECKED_STEPS, mix["batch"],
                                 mix["seq"], CPU)
    tally = []

    def recorded(cfg_, params, tokens, matmul_):
        tally.append(ref_model.Routes())
        return ref_model.loss(cfg_, params, tokens, matmul_, tally[-1])

    ref_steps.run(cfg, mix, 11, batches, CPU, recorded, ref_base._f32_matmul)
    routes = [dict(t.recorded) for t in tally]
    last = cfg["num_hidden_layers"] - 1
    choice, _ = routes[1][last]
    choice = choice.clone()
    e, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    for t in range(5):
        choice[t, -1] = next(j for j in range(e) if j not in choice[t])
    capacity = max(1, int(cfg["capacity_factor"] * choice.shape[0] * k / e))
    routes[1][last] = (choice, ref_model._kept(choice, e, capacity))
    want = tl.followed(cfg, mix, 11, batches, CPU, ref_base._f32_matmul,
                       routes, [0, 4, None])
    assert want["routing_flips"][:2] == [0, 5]
    assert want["routing_faults"] == 1


def _forward(t0, layers, recompute=True):
    """One step's marks: the forward's sublayers of 10 us each, then the
    backward (with the recomputed sublayers inside it) and the rest."""
    ops, t = [(marks.kernel_name("forward"), t0, 1.0)], t0 + 1.0
    for kind in layers:
        for name in (f"attn_{kind}", "moe"):
            ops.append((marks.kernel_name(name), t, 1.0))
            t += 10.0
    ops.append((marks.kernel_name("head"), t, 1.0))
    t += 5.0
    ops.append((marks.kernel_name("backward"), t, 1.0))
    if recompute:
        for kind in layers:
            ops.append((marks.kernel_name(f"attn_{kind}"), t + 3.0, 1.0))
    for phase in marks.PHASES[2:]:
        t += 50.0
        ops.append((marks.kernel_name(phase), t, 1.0))
    return ops


def test_sublayer_metrics_read_the_forward_alone():
    layers = ("sliding", "sliding", "sliding", "full")
    ops = sorted(_forward(0.0, layers) + _forward(1000.0, layers),
                 key=lambda o: o[1])
    trace = tracing.Trace(cell=dict(harness.cell(MELLUM),
                                    cfg=tl.weights_cfg(harness.cell(MELLUM)
                                                       ["cfg"])),
                          steps=2, window_s=1.0, ops=ops, gaps=[], host={})
    read = {n: harness.metric_reader(n).read(trace)
            for n in ("attn_sliding_fwd_ms", "attn_full_fwd_ms",
                      "moe_fwd_ms", "attn_fwd_roofline")}
    assert read["attn_sliding_fwd_ms"] == pytest.approx(0.030)
    assert read["attn_full_fwd_ms"] == pytest.approx(0.010)
    assert read["moe_fwd_ms"] == pytest.approx(0.040)
    assert sublayers.forward_ms(trace, ("head",)) == pytest.approx(0.005)
    assert read["attn_fwd_roofline"] > 0
    # a window without the sublayer marks (an older program) reads nothing
    bare = [o for o in ops if not any(
        o[0] == marks.kernel_name(p) for p in marks.SUBPHASES)]
    trace.ops = bare
    assert all(harness.metric_reader(n).read(trace) is None for n in read)


def test_attention_work_at_the_published_length():
    from bench.metrics import attn_fwd_roofline as roof

    assert roof.allowed_pairs(8192, None) == 33_558_528
    assert roof.allowed_pairs(8192, 1024) == 7_864_832
    cfg = tl.weights_cfg(harness.cell(MELLUM)["cfg"])
    proj = 2 * 8192 * (2 * 2304 * 4096 + 2 * 2304 * 512)
    want = 4 * proj + 4 * 4096 * (33_558_528 + 3 * 7_864_832)
    assert roof.needed_flops(cfg, 1, 8192) == want


@pytest.mark.parametrize("name", tiny.CELLS)
def test_reference_steps_are_the_one_model_reference(name):
    """`bench.reference.steps.run` with the one-model loss reads what
    `bench.reference.train.run` reads, bit for bit: the same steps in the
    same order, with the codec and error feedback (ndsc) or without
    (psum)."""
    c = tiny.cell(name)
    cfg, mix = c["cfg"], c["mix"]
    batches = weights.token_rows(cfg, 7, one.CHECKED_STEPS, mix["batch"],
                                 mix["seq"], CPU)
    want = reference.run(cfg, mix, 7, batches, CPU)
    got = ref_steps.run(cfg, mix, 7, batches, CPU, ref_base.loss)
    assert got == want


def test_the_line_reports_the_cards_the_cell_asks_for():
    """The result line's device count is the cards the cell asks for."""
    import json

    c = tiny.cell("yi6b-train-ndsc")
    done = run.execute(c, 2 ** 33 + 5, 0.1, False, CPU, time.perf_counter())
    device = json.loads(done["line"])["device"]
    assert (device["platform"], device["count"]) == ("cpu", c["chips"])
