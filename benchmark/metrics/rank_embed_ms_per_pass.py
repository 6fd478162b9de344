"""Device ms a ranking pass in the model's embeddings: the program's
``eval.embeddings`` span (``Trainer.evaluate``: the graph propagation
forward) over its ``eval.passes``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "rank_embed_ms_per_pass", "eval.embeddings", "eval.passes", "passes")
