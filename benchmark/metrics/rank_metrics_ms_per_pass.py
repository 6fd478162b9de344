"""Device ms a ranking pass in the metrics: the program's ``eval.metrics``
span (``Trainer.evaluate``: ``gene_metrics_pair`` with its host copy)
over its ``eval.passes``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "rank_metrics_ms_per_pass", "eval.metrics", "eval.passes", "passes")
