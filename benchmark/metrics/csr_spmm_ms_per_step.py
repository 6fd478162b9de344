"""Device ms a training step in the segment graph's CSR gather-sum (the
kernels of the program's ``csrc/csr_spmm.cu``, whose names hold
``csr_spmm``: its propagation sums forward and their gradients). The trace's
count of those kernels must equal the program's ``graph.csr_spmm`` counter
(one a launch), else nothing is read; a program without the kernel reads
nothing."""

from benchmark.harness.spans import count, say


def is_csr_spmm(name):
    return "csr_spmm" in name


def read(ctx):
    steps = ctx.win.units.get("steps", 0)
    kernels = ctx.trace.count_where(is_csr_spmm)
    if not steps or not kernels:
        return None
    launched = count(ctx, "graph.csr_spmm")
    if launched != kernels:
        say("csr_spmm_ms_per_step", f"the trace holds {kernels} csr_spmm kernels, the "
                                    f"program's graph.csr_spmm counter {launched}")
        return None
    return 1e3 * ctx.trace.seconds_where(is_csr_spmm) / steps
