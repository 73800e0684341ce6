"""The batched LU's share of its roofline: the least time of the window's
survey LUs (each survey one LU of its shifts' n x n operators, counted by
``roofline/lu.py`` from the shapes the survey's wrapper kept) over the
device time of the operations launched inside the program's span
``layer.survey.lu``.  %.  Nothing from a program whose ``SPANS`` lacks
the span."""

from portbench.program_spans import optional_span
from portbench.roofline import lu
from portbench.tracing import inside


def read(ctx):
    got = optional_span(ctx, "layer.survey.lu")
    calls = ctx.spans.kept.get(("solver", "window"), [])
    if got is None or not calls:
        return None
    s = ctx.summary
    mine = inside(s["launch"], got) & (s["launch"] >= 0)
    t = float(s["durs"][mine].sum()) * 1e-9
    if t <= 0:
        return None
    least = sum(lu.least_s(c["n"], c["shifts"]) for c in calls)
    return 100.0 * least / t
