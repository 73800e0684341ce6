"""K1's share of its roofline: the least time of the window's K1 calls
(each the larger of its operations over 67 TFLOP/s and its bytes over
3.35 TB/s, counted from the algorithm in ``roofline/k1.py``) over K1's
device time in the trace.  The share of nodes on the asymptotic side of
the Bessel split is measured on the set-up requests' K1 calls, drawn from
the same traffic.  %."""

import numpy as np

from portbench.roofline import common, k1


def read(ctx):
    idx = ctx.kernels("kappa_pairs_kernel")
    calls = ctx.spans.kept.get(("k1", "window"), [])
    warm = ctx.spans.kept.get(("k1", "setup"), [])
    if not idx or not calls or not warm or len(idx) != len(calls):
        return None
    asym = float(np.mean([w["asym"] for w in warm]))
    least = 0.0
    for c in calls:
        flop, nbytes = k1.call_work(*c["shape"], asym)
        least += common.bound_s(flop, nbytes)[0]
    t = float(ctx.summary["durs"][idx].sum()) * 1e-9
    return 100.0 * least / t
