"""Cells of the benchmark at a size the CPU can run in seconds: the
configuration's widths cut to a toy (these tests check the harness, the
reference and the comparison, not the model's size), two layers, batch 4
of 16 tokens."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

CELLS = ("yi6b-train-ndsc", "mixtral-train-ndsc", "yi6b-train-psum")
LIMITS = {"loss1", "grad", "grad2", "change"}


def cell(name: str) -> dict:
    c = harness.cell(name)
    c["cfg"] = dict(c["cfg"], hidden_size=128, intermediate_size=256,
                    num_attention_heads=4, num_key_value_heads=2,
                    vocab_size=512, num_hidden_layers=2)
    c["mix"] = dict(c["mix"], batch=4, seq=16)
    return c
