"""Device ms a ranking pass in masking and top-k: the program's
``eval.select`` span (``eval/ranking.mask_and_topk``: ``mask_rows`` and
``torch.topk`` of each chunk) over its ``eval.passes``."""

from benchmark.harness.spans import per_unit


def read(ctx):
    return per_unit(ctx, "rank_select_ms_per_pass", "eval.select", "eval.passes", "passes")
