"""The share of the traced training window in which nothing ran on the card."""


def read(ctx):
    return ctx.trace.idle_pct
