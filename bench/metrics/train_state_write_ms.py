"""train_state_write_ms: device milliseconds a training step spends in the
state write: p.add_ of the updates and the new optimizer state written
into the old (`_into`), from the state-write mark to the step-end mark
(`bench.phases`), over the steps traced."""
from bench import phases

LAYER = "state write (dist/step.py: p.add_, _into)"
MOVES = "train_tokens_per_s"


def read(trace):
    return phases.phase_ms(trace, "state_write")
