"""Device operations a PIC run launches while ``cuda_pic.run`` sets the run
up: the kernels, copies and sets whose launch (the host time of their
runtime call) falls inside the program's span ``layer.pic.setup``, over the
runs completed in the window; nothing from a window without device
operations (a run on the CPU)."""

from portbench.program_spans import optional_span
from portbench.tracing import inside


def read(ctx):
    got = optional_span(ctx, "layer.pic.setup")
    done = sum(1 for r in ctx.records if not r["failed"])
    if got is None or not done or not len(ctx.summary["launch"]):
        return None
    return int(inside(ctx.summary["launch"], got).sum()) / done
