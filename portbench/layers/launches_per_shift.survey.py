"""Kernel launches a shift: the device kernels the profiler saw in the
window (copies and sets left out) over the shifts of the surveys
completed."""


def read(ctx):
    shifts = sum(r["shifts"] for r in ctx.records if not r["failed"])
    kernels = int((~ctx.summary["copy"]).sum())
    if not shifts or not kernels:
        return None
    return kernels / shifts
