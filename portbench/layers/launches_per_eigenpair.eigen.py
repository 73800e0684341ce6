"""Kernel launches an eigenpair: the device kernels the profiler saw in
the window (copies and sets left out) over the eigenpairs completed."""


def read(ctx):
    done = sum(1 for r in ctx.records if not r["failed"])
    kernels = int((~ctx.summary["copy"]).sum())
    if not done or not kernels:
        return None
    return kernels / done
