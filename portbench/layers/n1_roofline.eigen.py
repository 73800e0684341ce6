"""N1's share of its roofline: the least time of the window's N1 launches
(their float64 operations, counted from the work each integral did by
``roofline/n1.py``, over its peak) over N1's device time in the trace
(``adaptive_kernel``).  The panel and Miller-step sums of each launch are
kept as device scalars in the window and read here, after it.  %."""

from portbench.roofline import n1


def read(ctx):
    idx = ctx.kernels("adaptive_kernel")
    calls = ctx.spans.kept.get(("n1", "window"), [])
    if not idx or not calls or len(idx) != len(calls):
        return None
    flop = sum(n1.flop(int(c["panels"]), int(c["miller"]), c["order"])
               for c in calls)
    t = float(ctx.summary["durs"][idx].sum()) * 1e-9
    return 100.0 * flop / n1.PEAK_F64_FLOP_PER_S / t
