"""Share of a request's wall time outside its call into the solver
(``eigen.solve`` or ``sparse_eigen.solve``): the driver's ``from_config``,
the quadrature guard and the result (spans ``portbench.request`` and
``layer.solver``, host clock).  %."""

from portbench.tracing import inside


def read(ctx):
    spans = ctx.summary["spans"]
    req, sol = spans.get("portbench.request"), spans.get("layer.solver")
    if req is None or sol is None or not len(req):
        return None
    total = float((req[:, 1] - req[:, 0]).sum())
    mine = inside(sol[:, 0], req)
    solver = float((sol[mine, 1] - sol[mine, 0]).sum())
    return 100.0 * (total - solver) / total
