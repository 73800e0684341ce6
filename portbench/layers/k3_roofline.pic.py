"""K3's share of its roofline: the least time of the window's K3 runs
(the larger of their operations over 67 TFLOP/s and their bytes over
3.35 TB/s, counted from the algorithm in ``roofline/k3.py``) over K3's
device time in the trace.  The share of markers on the asymptotic side of
the J0 / J1 split is read from the first request's draws.  %."""

from portbench.roofline import common, k3


def read(ctx):
    idx = ctx.kernels("pic_mega_kernel")
    if not idx:
        return None
    e = ctx.entry
    eta, _zp, z_perp, _w = e.draws(0)
    inp = e.input
    vt = float(inp["vt"])
    v_perp = (z_perp * vt / float(inp.get("water_bag_weight_vperp", 1.0))
              ** 0.5).abs()
    asym = k3.asymptotic_share(eta, v_perp, vt, float(inp["k_rho"]) ** 2,
                               float(inp["shat"]))
    flop, nbytes = k3.run_work(e.markers, e.n_steps, int(inp["npoints"]),
                               asym, bool(inp.get(
                                   "drift_center_transformation_switch")))
    least = common.bound_s(flop, nbytes)[0] * len(idx)
    t = float(ctx.summary["durs"][idx].sum()) * 1e-9
    return 100.0 * least / t
