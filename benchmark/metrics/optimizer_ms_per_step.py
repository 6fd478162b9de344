"""Device ms a training step in the optimizer: the program's
``train.optimizer`` span (``Trainer.train_step``: Adam over the dense
params, the store's refresh, the tables' row Adam) over its
``train.steps``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "optimizer_ms_per_step", "train.optimizer", "train.steps", "steps")
