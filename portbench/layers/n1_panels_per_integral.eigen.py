"""Kernel N1's panels an integral: the window's N1 launches' panel counts
(kept as device scalars in the window, read here, after it) over their
integrals.  It tells the refinement the inputs ask for (1 where every
integral accepts its first panel) from N1's speed a panel."""


def read(ctx):
    calls = ctx.spans.kept.get(("n1", "window"), [])
    if not calls or any("integrals" not in c for c in calls):
        return None
    integrals = sum(c["integrals"] for c in calls)
    if not integrals:
        return None
    return sum(int(c["panels"]) for c in calls) / integrals
