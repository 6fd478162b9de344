"""Device ms a training step in autograd's backward: the program's
``train.backward`` span (``Trainer.train_step``: ``bdot``'s backward, the
deterministic scatter, K2's dq and dk) over its ``train.steps``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "backward_ms_per_step", "train.backward", "train.steps", "steps")
