"""The card's idle a PIC run while ``cuda_pic.run`` sets the run up: the
length of the idle gaps that begin inside the program's span
``layer.pic.setup`` (its children ``layer.pic.params``, ``.qn`` and
``.arrs`` and their reads included), over the runs completed in the
window.  ms."""

from portbench.program_spans import optional_span
from portbench.span_idle import idle_inside_ns


def read(ctx):
    got = optional_span(ctx, "layer.pic.setup")
    done = sum(1 for r in ctx.records if not r["failed"])
    if got is None or not done or len(ctx.summary["starts"]) < 2:
        return None
    return idle_inside_ns(ctx.summary, got) * 1e-6 / done
