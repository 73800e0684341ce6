"""Share of the requests' wall time spent in the driver's quadrature guard:
the length of the program's span ``layer.driver.guard`` inside the
``portbench.request`` spans over the requests' length, on the profiler's
clock.  %."""

from portbench.tracing import inside


def program_spans(ctx, *names):
    """The window's intervals of each of the program's spans ``names``, or
    None where the program opens no spans of its own (its timer has no
    ``SPANS``).  Raises where a span is not the program's or never opened
    in the window: a renamed span must not read as zero."""
    try:
        from emme_tpu_torch.utils.timer import SPANS
    except ImportError:
        return None
    got = ctx.summary["spans"]
    for name in names:
        if name not in SPANS or not len(got.get(name, ())):
            raise RuntimeError(f"span {name} never opened in the window "
                               f"(renamed in the program?)")
    return [got[name] for name in names]


def read(ctx):
    got = program_spans(ctx, "layer.driver.guard")
    req = ctx.summary["spans"].get("portbench.request")
    if got is None or req is None or not len(req):
        return None
    guard = got[0]
    mine = inside(guard[:, 0], req)
    total = float((req[:, 1] - req[:, 0]).sum())
    return 100.0 * float((guard[mine, 1] - guard[mine, 0]).sum()) / total
