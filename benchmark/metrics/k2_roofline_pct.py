"""K2's share of its roofline over the window: the sum of each K2 call's
bound (``peaks.lse_bound`` of its forward, dq and dk at the step's
(B, N, E)) over the device time of the kernels of ``csrc/streaming_lse.cu``.
The calls are the reference's ``k2_calls`` a step times the steps; the
port's launch counters must agree (one forward, dq and dk launch a call),
else nothing is read."""

import sys

from benchmark.harness.peaks import k2_call_bound_ms

K2_KERNELS = ("lse_fwd64_kernel", "lse_fwd_kernel", "lse_combine_kernel", "lse_bwd64_kernel",
              "lse_dq_kernel", "lse_dk_kernel", "dq_combine_kernel", "split_sum_kernel")


def is_k2(name):
    return any(k in name for k in K2_KERNELS)


def read(ctx):
    t = ctx.cell.traffic
    calls = ctx.ref.k2_calls(ctx.cell.config["combo"], ctx.cat.num_user, ctx.cat.num_item,
                             int(t["batch_size"]))
    steps = ctx.win.units.get("steps", 0)
    seconds = ctx.trace.seconds_where(is_k2)
    if not calls or not steps or seconds <= 0:
        return None
    want = steps * len(calls)
    if any(ctx.launches.get(k, 0) != want for k in ("fwd", "dq", "dk")):
        print(f"k2_roofline_pct: launches {ctx.launches} differ from {want} of each",
              file=sys.stderr)
        return None
    bound_s = steps * sum(k2_call_bound_ms(*c) for c in calls) * 1e-3
    return 100.0 * bound_s / seconds
