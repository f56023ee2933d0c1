"""train_backward_ms: device milliseconds a training step spends in the
backward: torch.autograd.grad with the remat recompute, from the
backward mark to the consensus mark (`bench.phases`), over the steps
traced."""
from bench import phases

LAYER = "backward (torch.autograd.grad in dist/step.py _grads, the remat recompute inside)"
MOVES = "train_tokens_per_s"


def read(trace):
    return phases.phase_ms(trace, "backward")
