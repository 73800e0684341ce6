"""Share of the device's busy time spent in operations launched inside the
program's linear-algebra spans (``layer.linalg.step``: a Newton step's LU,
trace solve or selected inverse; ``layer.linalg.vector``: the null vector;
``layer.linalg.arnoldi``: the banded Arnoldi stage), from the profiler's
trace.  %."""

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
    got = program_spans(ctx, "layer.linalg.step", "layer.linalg.vector")
    s = ctx.summary
    durs = s["durs"]
    if got is None or not len(durs) or durs.sum() == 0:
        return None
    spans = np.concatenate([v for k, v in s["spans"].items()
                            if k.startswith("layer.linalg.")])
    mine = inside(s["launch"], spans) & (s["launch"] >= 0)
    return 100.0 * float(durs[mine].sum()) / float(np.sum(durs))
