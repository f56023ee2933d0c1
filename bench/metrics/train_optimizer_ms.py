"""train_optimizer_ms: device milliseconds a training step spends in the
optimizer: the global norm, the clip and the update, from the optimizer
mark to the state-write mark (`bench.phases`), over the steps traced."""
from bench import phases

LAYER = "optimizer (optimizer/optim.py: global norm, clip, update)"
MOVES = "train_tokens_per_s"


def read(trace):
    return phases.phase_ms(trace, "optimizer")
