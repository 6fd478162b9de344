"""Device ms of a ranking pass: every kernel, copy and memset in the window
over the passes run."""


def read(ctx):
    passes = ctx.win.units.get("passes", 0)
    if not passes:
        return None
    return 1e3 * sum(ctx.trace.op_seconds.values()) / passes
