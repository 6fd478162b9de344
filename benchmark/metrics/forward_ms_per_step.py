"""Device ms a training step in the loss forward: the program's
``train.forward`` span (``Trainer.train_step``: the model's loss, its
graph propagation, views and K2's forward) over its ``train.steps``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "forward_ms_per_step", "train.forward", "train.steps", "steps")
