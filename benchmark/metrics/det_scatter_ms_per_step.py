"""Device ms a training step in the deterministic mode's sorted scatter
(``indexing_backward_kernel*``: ``index_add_`` of the segment graph's
products and the gather backward of the tables' rows)."""


def is_scatter(name):
    return "indexing_backward_kernel" in name


def read(ctx):
    steps = ctx.win.units.get("steps", 0)
    if not steps or not ctx.trace.count_where(is_scatter):
        return None
    return 1e3 * ctx.trace.seconds_where(is_scatter) / steps
