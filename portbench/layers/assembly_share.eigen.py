"""Share of the device's busy time spent in kernels launched inside the
assembly spans (``eigen.assemble_matrix`` / ``sparse_eigen.assemble_bdia``:
K1 and the torch kernels around it), from the profiler's trace.  %."""

import numpy as np

from portbench.tracing import inside


def read(ctx):
    s = ctx.summary
    asm = s["spans"].get("layer.assembly")
    durs = s["durs"]
    if asm is None or not len(durs) or durs.sum() == 0:
        return None
    mine = inside(s["launch"], asm) & (s["launch"] >= 0)
    return 100.0 * float(durs[mine].sum()) / float(np.sum(durs))
