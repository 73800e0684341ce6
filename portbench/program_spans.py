"""The program's own spans as a per-layer reader of a newer span takes
them: nothing where the program does not name the span (a program from
before it), the window's intervals where it does, and an error where it
names the span and the span never opened (a renamed entry point must not
read as zero)."""

from __future__ import annotations


def optional_span(ctx, name: str):
    """The window's (k, 2) intervals of the program's span ``name``, or
    None where the program's ``SPANS`` lacks it (or it has no ``SPANS``)."""
    try:
        from emme_tpu_torch.utils.timer import SPANS
    except ImportError:
        return None
    if name not in SPANS:
        return None
    got = ctx.summary["spans"].get(name)
    if got is None or not len(got):
        raise RuntimeError(f"span {name} never opened in the window "
                           f"(renamed in the program?)")
    return got
