"""train_mfu: the whole training step's share of the card's f32 peak, in
%. The model FLOPs of a step (`bench.frozen.flops`: 6·N + 12·L·s·d a
token, N the weights in a token's products) over the seconds a step took
in the run's untraced window (host clock) times 67 TFLOP/s."""
from bench.frozen import cost

LAYER = "train step (dist/step.py captured dist.step)"
MOVES = "train_tokens_per_s"


def read(trace):
    step_s = trace.host.get("step_s")
    flops = trace.host.get("flops_per_step")
    if not step_s or not flops:
        return None
    return 100.0 * flops / (step_s * cost.PEAK_F32_FLOP_S)
