"""Share of the traced window in which the device idles while the host
assembles: the length of the device's idle gaps that begin inside the
program's spans ``layer.assembly.pairs`` (kernel values: K1 and the torch
kernels around it) or ``layer.assembly.place`` (writing them into the
operator), over the window.  Gaps as the trace's summary takes them: device
intervals sorted by start, a gap where the next start passes the running
maximum of the ends.  %."""

import numpy as np

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
    got = program_spans(ctx, "layer.assembly.pairs", "layer.assembly.place")
    s = ctx.summary
    if got is None or len(s["starts"]) < 2:
        return None
    order = np.argsort(s["starts"])
    starts = s["starts"][order]
    run_end = np.maximum.accumulate((s["starts"] + s["durs"])[order])
    gap_at, gap = run_end[:-1], starts[1:] - run_end[:-1]
    idle = gap > 0
    mine = inside(gap_at[idle], np.concatenate(got))
    return 100.0 * float(gap[idle][mine].sum()) * 1e-9 / s["window_s"]
