"""model_opt_ms_per_step: device milliseconds a training step spends in
every operation that is not the codec's (the model's forward, its
recomputation under remat and its backward; the optimizer; the step's
copies and fills), over the steps traced."""
from bench import harness

LAYER = "model and optimizer (models/model.py, models/moe.py, optimizer/optim.py)"
MOVES = "train_tokens_per_s"


def read(trace):
    codec = harness.metric_reader("codec_ms_per_step").KERNELS
    secs = trace.op_seconds(codec, exclude=True)
    if not trace.steps or secs <= 0.0:
        return None
    return 1e3 * secs / trace.steps
