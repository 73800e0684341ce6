"""Blocking device-to-host reads a PIC run: the program's
``layer.host_read`` spans that start inside a ``portbench.request`` span
(``FusedStep.params_vec``'s copies of the parameters, the fit's copy of the
statistics) over the runs completed.  Nothing from a program whose PIC
path opens no reads of its own (its ``SPANS`` lacks ``layer.pic.params``):
its count would read zero."""

from portbench.program_spans import optional_span
from portbench.tracing import inside


def read(ctx):
    if optional_span(ctx, "layer.pic.params") is None:
        return None
    got = optional_span(ctx, "layer.host_read")
    req = ctx.summary["spans"].get("portbench.request")
    done = sum(1 for r in ctx.records if not r["failed"])
    if req is None or not done:
        return None
    return int(inside(got[:, 0], req).sum()) / done
