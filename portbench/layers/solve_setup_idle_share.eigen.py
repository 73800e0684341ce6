"""Share of the traced window in which the card idles while a solve sets
itself up: the idle gaps that begin inside the program's span
``layer.solve.setup`` (``eigen.solve``, ``sparse_eigen.solve``,
``eigen_native.solve`` up to their first assembly: the argument checks,
the grid, the coefficients, the tiers' read of the length, the plan), over
the window.  Nothing from a program without the span.  %."""

from portbench.span_idle import idle_share


def read(ctx):
    return idle_share(ctx, "layer.solve.setup")
