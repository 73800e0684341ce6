"""Share of the PIC runs' wall time not covered by K3's device time:
marker state set-up, the wrappers around K3, the fit on the host
(requests by the host clock, K3 from the trace).  %."""


def read(ctx):
    idx = ctx.kernels("pic_mega_kernel")
    wall = sum(r["t1"] - r["t0"] for r in ctx.records)
    if not idx or wall <= 0:
        return None
    k3 = float(ctx.summary["durs"][idx].sum()) * 1e-9
    return 100.0 * (wall - k3) / wall
