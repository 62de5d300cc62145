"""Training (loop, step, state, checkpoints, schedule, metrics) and
inference helpers."""
