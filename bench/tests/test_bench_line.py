"""A run's result line: exactly the contract's keys, `breakdown` in a
traced run, `checks` last, every metric the cell declares."""
from __future__ import annotations

import json
import time

import pytest
import torch

import tiny
from bench import run


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", tiny.CELLS)
def test_result_line(name, trace):
    c = tiny.cell(name)
    done = run.execute(c, 2 ** 33 + 17, 0.2, trace,
                       torch.device("cpu"), time.perf_counter())
    line = json.loads(done["line"])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["checks"]) == tiny.LIMITS
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU nothing runs on a device: only the metrics of the
        # host's clock and the program's counters read
        assert set(line["metrics"]) == {
            m["name"] for m in c["per_layer"]
            if m["source"] != "device_trace"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in c["end_to_end"]}
        for m in line["metrics"].values():
            assert m["value"] > 0


def test_run_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "yi6b-train-ndsc", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
