"""device_idle_share.train: the share of the traced window of training
steps in which no operation ran on the device, in %."""
LAYER = "device"
MOVES = "train_tokens_per_s"


def read(trace):
    if trace.window_s <= 0.0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
