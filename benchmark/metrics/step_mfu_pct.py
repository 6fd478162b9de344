"""The whole training step's share of the card's fp32 peak: the model work of
a step (the reference's ``step_flops``: products over the edge list for the
main graph and any views, forward and backward; each catalog logsumexp's
logits, dq and dk; the BPR scores), times the steps in the window, over
the window's seconds and 67 TFLOP/s. A dense R's U I d products are not
counted: the count is the same whatever implements the step."""

from benchmark.harness.peaks import PEAK_FP32_FLOPS


def read(ctx):
    steps = ctx.win.units.get("steps", 0)
    if not steps:
        return None
    t = ctx.cell.traffic
    flops = ctx.ref.step_flops(ctx.cell.config["combo"], ctx.cat.num_user, ctx.cat.num_item,
                               ctx.cat.num_edges, int(t["batch_size"]))
    return 100.0 * flops * steps / (ctx.win.seconds * PEAK_FP32_FLOPS)
