"""Device ms a training step in the sampler: the program's ``train.sample``
span (``Trainer.bpr_batch``: ``sample_negatives``, and the second draw of
a model that needs interest items) over its ``train.steps``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "sample_ms_per_step", "train.sample", "train.steps", "steps")
