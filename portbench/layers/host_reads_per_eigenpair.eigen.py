"""Blocking device-to-host reads an eigenpair: the program's
``layer.host_read`` spans that start inside a ``portbench.request`` span
(scalar reads, the device loop's flag polls, the guard's and the result's
copies) over the eigenpairs completed."""

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
    got = program_spans(ctx, "layer.host_read")
    req = ctx.summary["spans"].get("portbench.request")
    done = sum(1 for r in ctx.records if not r["failed"])
    if got is None or req is None or not done:
        return None
    return int(inside(got[0][:, 0], req).sum()) / done
