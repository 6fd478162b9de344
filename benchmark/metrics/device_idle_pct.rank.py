"""The share of the traced ranking window in which nothing ran on the card."""


def read(ctx):
    return ctx.trace.idle_pct
