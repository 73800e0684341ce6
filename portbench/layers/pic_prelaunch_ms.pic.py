"""Host time from a PIC request's start to K3's launch: the mean over the
requests of the start of the first program span ``layer.pic.k3`` inside a
``portbench.request`` span less the request's start (the draws handed to
``pic.state_from_draws``, then ``cuda_pic.run``'s set-up: ``FusedStep``, the
initial state, the quasi-neutrality coefficient, the marker arrays, the
grid-sync self-check), on the profiler's clock.  ms."""

import numpy as np


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
    got = program_spans(ctx, "layer.pic.k3")
    req = ctx.summary["spans"].get("portbench.request")
    if got is None or req is None or not len(req):
        return None
    k3 = np.sort(got[0][:, 0])
    k = np.searchsorted(k3, req[:, 0], side="left")
    ok = k < len(k3)
    ok[ok] = k3[k[ok]] <= req[ok, 1]
    if not ok.any():
        raise RuntimeError("no request opened layer.pic.k3")
    return float((k3[k[ok]] - req[ok, 0]).mean()) * 1e-6
