"""Share of the device's busy time (the sum of its operations' times, as
``assembly_share.eigen`` takes it) spent in operations launched inside the
program's span ``layer.survey.sweep``: a survey's batched Arnoldi sweep
(``arnoldi.arnoldi_factorization`` over its shifts).  %.  Nothing from a
program whose ``SPANS`` lacks the span."""

import numpy as np

from portbench.program_spans import optional_span
from portbench.tracing import inside


def read(ctx):
    got = optional_span(ctx, "layer.survey.sweep")
    s = ctx.summary
    durs = s["durs"]
    if got is None or not len(durs) or durs.sum() == 0:
        return None
    mine = inside(s["launch"], got) & (s["launch"] >= 0)
    return 100.0 * float(durs[mine].sum()) / float(np.sum(durs))
