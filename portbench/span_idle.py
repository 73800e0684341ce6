"""The card's idle gaps by the program's span they begin inside, for the
per-layer readers of a span's idle: gaps as the trace's summary takes them
(device intervals sorted by start, a gap where the next start passes the
running maximum of the ends), a gap counted where it begins inside any
interval of the span, its children's included (``tracing.inside``)."""

from __future__ import annotations

import numpy as np

from portbench.program_spans import optional_span
from portbench.tracing import inside


def idle_inside_ns(summary, intervals) -> int:
    """The length in ns of the window's idle gaps that begin inside
    ``intervals`` (k, 2)."""
    order = np.argsort(summary["starts"])
    starts = summary["starts"][order]
    run_end = np.maximum.accumulate(
        (summary["starts"] + summary["durs"])[order])
    gap_at, gap = run_end[:-1], starts[1:] - run_end[:-1]
    idle = gap > 0
    return int(gap[idle][inside(gap_at[idle], intervals)].sum())


def idle_share(ctx, name: str):
    """The share of the window, %, in which the card idles after a gap
    began inside the program's span ``name``; None where the window holds
    fewer than two device operations (a run on the CPU has none) or the
    program does not name the span."""
    s = ctx.summary
    if len(s["starts"]) < 2:
        return None
    got = optional_span(ctx, name)
    if got is None:
        return None
    return 100.0 * idle_inside_ns(s, got) * 1e-9 / s["window_s"]
