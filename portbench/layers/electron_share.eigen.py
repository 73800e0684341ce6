"""Share of the device's busy time spent in operations launched inside the
program's span ``layer.assembly.electron`` (an electromagnetic exact
assembly's electron closed forms for moments 1 and 2 and its A_par
diagonal, ``native.assemble``), from the profiler's trace.  %.

Reads nothing from a program whose ``SPANS`` lacks the span (it keeps that
work under ``layer.assembly.pairs``); raises where ``SPANS`` names it and
it never opened in the window: a renamed span must not read as zero."""

import numpy as np

from portbench.tracing import inside

NAME = "layer.assembly.electron"


def read(ctx):
    try:
        from emme_tpu_torch.utils.timer import SPANS
    except ImportError:
        return None
    if NAME not in SPANS:
        return None
    s = ctx.summary
    got = s["spans"].get(NAME)
    if got is None or not len(got):
        raise RuntimeError(f"span {NAME} never opened in the window "
                           f"(renamed in the program?)")
    durs = s["durs"]
    if not len(durs) or durs.sum() == 0:
        return None
    mine = inside(s["launch"], got) & (s["launch"] >= 0)
    return 100.0 * float(durs[mine].sum()) / float(np.sum(durs))
