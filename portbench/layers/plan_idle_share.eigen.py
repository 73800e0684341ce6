"""Share of the traced window in which the card idles while the host makes
an assembly plan: the idle gaps that begin inside the program's span
``layer.assembly.plan`` (``eigen.assembly_plan`` on the card's kernel
route, ``native.assembly_plan`` and N1's memo's places,
``cuda_adaptive.Memo.place``), over the window.  Nothing from a program
without the span.  %."""

from portbench.span_idle import idle_share


def read(ctx):
    return idle_share(ctx, "layer.assembly.plan")
