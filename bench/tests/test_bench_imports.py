"""A run loads neither JAX nor the JAX package `repro` (compared by the
whole top-level name: `repro_torch` begins with `repro`), and refuses to
print a result where a checkout holds only the benchmark's files."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from tiny import ROOT

SCRIPT = """
import sys, time, json
sys.path[:0] = [{root!r}, {src!r}, {tests!r}]
import torch, tiny
from bench import harness, run
done = run.execute(tiny.cell("mixtral-train-ndsc"), 5, 0.1, True,
                   torch.device("cpu"), time.perf_counter())
print(json.dumps({{"loaded": harness.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax():
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"),
                         tests=str(ROOT / "bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["loaded"] == []
    assert "repro_torch" in seen["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(seen["top"])


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "yi6b-train-ndsc",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_cell_on_the_card(card, tmp_path):
    """On a card: one short run of the first cell is correct."""
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "yi6b-train-ndsc",
         "--seed", str(2 ** 33 + 5), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
