"""Newton steps an eigenpair: the ``iteration_steps`` the driver returns,
over the window's requests."""


def read(ctx):
    steps = [r["steps"] for r in ctx.records if not r["failed"]]
    return sum(steps) / len(steps) if steps else None
