"""Kernel N1: float64 adaptive Gauss-Kronrod integrals, one per (pair,
moment), on the card; its plain version on the CPU.

The port of the reference-exact C++ engine ``native/emme_native.cpp``
(``integrate_adaptive``; no TPU kernel stands behind it: the JAX package
runs that engine on the CPU).  ``integrate`` launches ``csrc/adaptive.cu``
for CUDA tensors and counts each launch in ``LAUNCHES``; for CPU tensors it
runs the plain version ``ops/adaptive.integrate_ref``.  A failed build or
launch raises: nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from . import adaptive

LAUNCHES = 0
# the shape of the last launch: slots a warp (integrals a warp holds at a
# time: 2 under G7K15, 1 under G15K31), blocks (the co-resident grid, or
# fewer for a small n), registers and local (spill) bytes a thread
LAST_LAUNCH: dict = {}
_SHAPE_KEYS = ("slots", "blocks", "registers", "local_bytes")

# float64 operations of the engine's function, as the plain version writes
# it, each add, subtract, multiply, divide and square root and each libm
# call (tan, cos, sin, atan, exp, hypot) once: a step of the
# Miller recurrence (2k, 2k ratio, the quotient's two divisions, the complex
# product and add, the running sum, hypot); a node outside the recurrence on
# its shortest path (the node's abscissa, the integrand up to the -40
# cutoff, the Bessel function's set-up and normalisation); a node's share of
# its panel's Kronrod and Gauss sums; a panel's own (mid, half, integral,
# error, the two tests, the sum).  They count the function's work, not a
# kernel's instructions (N1's step now takes a reciprocal and fma
# corrections for the divisions and skips most hypot calls), so one bound
# holds every version of N1 to the same work.  The bound counts every node
# on the cutoff path, so it is a least time.
FLOP_PER_MILLER_STEP = 16
FLOP_PER_NODE = 176
FLOP_PER_NODE_SUM = 5
FLOP_PER_PANEL = 19


def flop_count(panels, miller, order) -> float:
    """The float64 operations of N1 (or its plain version) on the data it
    ran: from the per-integral panel counts and Miller steps."""
    nodes = float(panels.sum()) * (2 * len(adaptive.gk_rule(order)[0]) - 1)
    return (FLOP_PER_MILLER_STEP * float(miller.sum())
            + (FLOP_PER_NODE + FLOP_PER_NODE_SUM) * nodes
            + FLOP_PER_PANEL * float(panels.sum()))


def build() -> dict:
    """Compile ``csrc/adaptive.cu`` unless built; the build record."""
    return _build.build("adaptive")


def library():
    lib, _record = _build.load("adaptive")
    fn = lib.adaptive_launch
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, ctypes.c_longlong, vp, ctypes.c_int,
                       ctypes.c_int, vp, vp, vp, vp, vp, vp]
        fn.restype = ctypes.c_int
        lib.adaptive_max_subdivide.argtypes = []
        lib.adaptive_max_subdivide.restype = ctypes.c_int
    return lib


def _launch(rows, m, sc: adaptive.Scalars):
    global LAUNCHES
    n = rows.shape[0]
    dev = rows.device
    out = torch.empty((n, 2), dtype=torch.float64, device=dev)
    panels = torch.empty(n, dtype=torch.int32, device=dev)
    miller = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out, panels, miller
    lib = library()
    if not 0 <= sc.max_subdivide <= lib.adaptive_max_subdivide():
        raise ValueError(f"adaptive kernel: max_subdivide must be in 0.."
                         f"{lib.adaptive_max_subdivide()}, got "
                         f"{sc.max_subdivide}")
    scal = np.array([sc.om_r, sc.om_i, sc.arc, sc.qR, sc.vt, sc.wsi,
                     sc.eta_i, sc.rel_tol, sc.precision_goal], np.float64)
    info = np.zeros(len(_SHAPE_KEYS), np.int32)
    # the slots' work counter: the kernel hands out integrals from it
    nxt = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaptive_launch(rows.data_ptr(), m.data_ptr(), n,
                                  scal.ctypes.data, sc.order,
                                  sc.max_subdivide, out.data_ptr(),
                                  panels.data_ptr(), miller.data_ptr(),
                                  nxt.data_ptr(), stream, info.ctypes.data)
    if err != 0:
        raise RuntimeError(f"adaptive kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(zip(_SHAPE_KEYS, map(int, info)))
    return out, panels, miller


def integrate(rows, m, sc: adaptive.Scalars):
    """One adaptive integral per row of ``rows`` ((n, 4) float64 pair rows,
    ``adaptive.pair_rows``) with moment ``m`` ((n,) int32) at the scalars
    ``sc``: (values (n, 2) float64 [re, im], panels (n,) int32, Miller steps
    (n,) int64).  On a CUDA tensor kernel N1 (one launch), on a CPU tensor
    the plain version."""
    adaptive.gk_rule(sc.order)
    n = rows.shape[0]
    if rows.dtype != torch.float64 or tuple(rows.shape) != (n, 4) \
            or m.dtype != torch.int32 or tuple(m.shape) != (n,) \
            or m.device != rows.device:
        raise ValueError(
            f"adaptive integrals: rows must be (n, 4) float64 and m (n,) "
            f"int32 on one device, got {rows.dtype} {tuple(rows.shape)} on "
            f"{rows.device}, {m.dtype} {tuple(m.shape)} on {m.device}")
    if rows.is_cuda:
        return _launch(rows.contiguous(), m.contiguous(), sc)
    return adaptive.integrate_ref(rows, m, sc)
