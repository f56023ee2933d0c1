"""train_consensus_ms: device milliseconds a training step spends in the
consensus: the loss's mean over the workers and each leaf's EF add,
casts, codec kernels, decode and residual write, from the consensus mark
to the optimizer mark (`bench.phases`), over the steps traced."""
from bench import phases

LAYER = "consensus (dist/step.py _consensus_leaves: EF add, casts, codec kernels, decode, residual write)"
MOVES = "train_tokens_per_s"


def read(trace):
    return phases.phase_ms(trace, "consensus")
