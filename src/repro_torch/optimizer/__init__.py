"""Tree optimizers: AdamW, SGD, schedules and clipping."""
