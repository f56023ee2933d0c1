"""codec_roofline: the codec's least time over its device time a step, in
%. The least time is what the step's work needs, from the leaf sizes,
the chunk and R (`bench.frozen.cost`): each leaf's encode with error
feedback, the unpack of its payload and the inverse FWHT of the decode,
each at the larger of its bytes over 3.35 TB/s and its operations over
67 TFLOP/s. The device time is `codec_ms_per_step`'s."""
import math

from bench import harness, weights
from bench.frozen import cost

LAYER = "kernels (csrc/quantencode.cu, quantpack.cu, fwht.cu)"
MOVES = "train_tokens_per_s"


def least_s(cfg: dict, mix: dict) -> float:
    chunk, bits = mix["chunk"], mix["bits"]
    total = 0.0
    for _, shape in weights.leaf_shapes(cfg):
        rows = -(-math.prod(shape) // chunk)
        coords = rows * chunk
        total += cost.bound_s(*cost.encode_ef(coords, rows, chunk, bits))
        total += cost.bound_s(*cost.unpack_dequant(coords, rows, bits))
        total += cost.bound_s(*cost.fwht(coords, chunk))
    return total


def read(trace):
    mix = trace.cell["mix"]
    if mix.get("strategy") == "psum":
        return None
    ms = harness.metric_reader("codec_ms_per_step").read(trace)
    if ms is None:
        return None
    return 100.0 * least_s(trace.cell["cfg"], mix) / (ms * 1e-3)
