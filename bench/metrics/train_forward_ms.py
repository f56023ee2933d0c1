"""train_forward_ms: device milliseconds a training step spends in the
forward: the model's loss (`dist/step.py` `_grads`), from the forward
mark to the backward mark (`bench.phases`), over the steps traced."""
from bench import phases

LAYER = "forward (models/model.py, models/moe.py via dist/step.py _grads)"
MOVES = "train_tokens_per_s"


def read(trace):
    return phases.phase_ms(trace, "forward")
