"""N1, the float64 adaptive Gauss-Kronrod integrals of the reference-exact
engine: its operations from the work each integral did, frozen from the
engine's function (``native/emme_native.cpp``'s ``integrate_adaptive``):
each add, subtract, multiply, divide, square root and libm call once.  A
step of the Miller recurrence 16; a node outside it 176 and its share of
its panel's Kronrod and Gauss sums 5; a panel's own work 19.  No cell reads
it yet: the reference-exact path is not reached from the driver (PERF.md,
Open questions).  Its peak is the data sheet's float64 rate outside the
tensor cores, 34 TFLOP/s, an FMA as two.
"""

from __future__ import annotations

PEAK_F64_FLOP_PER_S = 34e12
PER_MILLER_STEP = 16
PER_NODE = 176
PER_NODE_SUM = 5
PER_PANEL = 19


def flop(panels: float, miller_steps: float, kronrod_nodes: int) -> float:
    """Operations of integrals that used ``panels`` panels of
    ``kronrod_nodes`` nodes (15: G7K15, 31: G15K31) and ``miller_steps``
    Miller steps in all."""
    nodes = panels * kronrod_nodes
    return (PER_MILLER_STEP * miller_steps + (PER_NODE + PER_NODE_SUM) * nodes
            + PER_PANEL * panels)
