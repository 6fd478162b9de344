"""Device ms a ranking pass in the chunks' scores: the program's
``eval.score`` span (``eval/ranking.py``: each chunk's bf16 casts and
``bdot``) over its ``eval.passes``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "rank_score_ms_per_pass", "eval.score", "eval.passes", "passes")
