"""Share of the traced window in which no kernel, copy or set ran on the
card.  %."""


def read(ctx):
    s = ctx.summary
    if s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
