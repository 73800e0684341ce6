"""What a roofline share is measured against, and how operations are
counted.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 67 TFLOP/s in float32
outside the tensor cores (an FMA counts as two operations), 3.35 TB/s of
HBM3, a 50 MB L2.  The card's power limit is printed beside every share.

Operations are counted from the algorithm, not from a binary: ``Tally``
evaluates a kernel's plain formula once on symbolic scalars and counts
each add, subtract, multiply, divide and each call of sqrt, rsqrt, exp,
sin, cos, floor as one operation; an operation between two constants is
folded and counts nothing; a select counts nothing.  A SASS count (what a
build happens to execute) would fall with every instruction a later
redesign removes, so a faster kernel doing the same work would read as a
lower share of its own bound.
"""

from __future__ import annotations

PEAK_F32_FLOP_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6


class Tally:
    """Counts the operations of a formula evaluated on ``V`` values."""

    def __init__(self):
        self.ops = 0

    def v(self):
        return V(self)

    def fn(self, x):
        """One call of a unary function (sqrt, exp, sin, ...)."""
        if isinstance(x, V):
            self.ops += 1
            return V(self)
        return x


class V:
    """A symbolic float: arithmetic on it counts one operation."""

    def __init__(self, tally: Tally):
        self.t = tally

    def _op(self, _other=None):
        self.t.ops += 1
        return V(self.t)

    __add__ = __radd__ = __sub__ = __rsub__ = _op
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _op

    def __neg__(self):
        return self


def bound_s(flop: float, nbytes: float) -> tuple[float, str]:
    """The least time on the card and what bounds it."""
    tc, tb = flop / PEAK_F32_FLOP_PER_S, nbytes / PEAK_BYTES_PER_S
    return (tc, "operations") if tc >= tb else (tb, "bytes")
