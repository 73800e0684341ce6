"""Kernel N1: float64 adaptive Gauss-Kronrod integrals, one per (pair,
moment), on the card; its plain version on the CPU.

The port of the reference-exact C++ engine ``native/emme_native.cpp``
(``integrate_adaptive``; no TPU kernel stands behind it: the JAX package
runs that engine on the CPU).  ``integrate`` launches ``csrc/adaptive.cu``
for CUDA tensors and counts each launch in ``LAUNCHES``; for CPU tensors it
runs the plain version ``ops/adaptive.integrate_ref``.  A failed build or
launch raises: nothing falls back.

``Memo`` carries N1's device memo through the launches of one solve, which
integrate the same rows at a sequence of omega: each node's omega-free
half (the Miller recurrence and nine tenths of the rest,
``csrc/adaptive_node.h``) is written once, by the solve's second launch,
and read by the later ones, which evaluate only the omega half of a node
whose panel the memo holds.  Values and panel counts are the memo-free
launch's bit for bit; the Miller steps count the recurrences a launch ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from .. import _build
from ..utils.timer import host_read, span
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

# launch modes (csrc/adaptive.cu: Mode)
PLAIN, FILL, READ = 0, 1, 2
# the largest share of the card's free memory, the caching allocator's free
# blocks counted as free, that one solve's memo takes
MEMO_SHARE = 0.5
# a memo's allocation is rounded up to a power of this ratio, so that the
# solves of a scan ask the caching allocator for a few sizes
MEMO_GROWTH = 2.0 ** 0.125
# float64 fields of a node's record (csrc/adaptive_node.h: Half)
MEMO_FIELDS = 21


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
                       ctypes.c_int, vp, vp, vp, vp, vp, vp, ctypes.c_int, vp,
                       vp, vp, vp, ctypes.c_longlong, vp]
        fn.restype = ctypes.c_int
        lib.adaptive_max_subdivide.argtypes = []
        lib.adaptive_max_subdivide.restype = ctypes.c_int
        lib.adaptive_record_doubles.argtypes = [ctypes.c_int]
        lib.adaptive_record_doubles.restype = ctypes.c_int
    return lib


def record_doubles(order: int) -> int:
    """float64 a panel's record holds: each node's fields at the stride of
    a slot's lanes (16 under G7K15, 32 under G15K31)."""
    return MEMO_FIELDS * (32 if order == 31 else 16)


def panel_bytes(order: int) -> int:
    """A memo's bytes a panel: its record and its key [lo, hi]."""
    return 8 * (record_doubles(order) + 2)


def memo_capacity(free_bytes: int, order: int) -> int:
    """Panels a memo may hold where ``free_bytes`` are free: ``MEMO_SHARE``
    of them, the allocation's rounding up included."""
    return int(MEMO_SHARE * free_bytes / MEMO_GROWTH) // panel_bytes(order)


def memo_budget(device, order: int) -> int:
    """``memo_capacity`` of the card's free memory, the caching allocator's
    free blocks counted as free (no device access)."""
    free, _total = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return memo_capacity(free + cached, order)


class Memo:
    """One solve's device memo of N1's node halves, over the launches of
    ``integrate(rows, m, sc, memo=)`` on one set of rows at any omega (the
    other scalars fixed).  The first launch runs plain and keeps its panel
    counts.  The second places the integrals, each a place as long as its
    first panel count, the prefix whose places fit ``memo_budget`` (one
    host read: the prefix and its total), and fills their places with the
    panels it visits.  The later launches read the memo.  A launch whose
    sign(Re omega) is not the first's runs plain, and so does every launch
    once the second did not fill.  ``stats``: a memo launch's [nodes
    memoised, nodes in full] (int64 on the device; memoised: written by a
    fill, read by a read)."""

    def __init__(self):
        self.launches = 0
        self.rows = None       # (data_ptr, integrals) of the first launch
        self.fixed = None      # its scalars, omega left out
        self.sign = None       # its sign(Re omega)
        self.panels = None     # its panel counts, until the places are made
        self.n = 0             # integrals memoised: a prefix
        self.bytes = 0         # the memo's allocation
        self.cum = self.nrec = self.rec = self.keys = None
        self.stats = []
        self.last = None       # the last launch's route

    def route(self, rows, sc: adaptive.Scalars) -> str:
        """This launch's route: "first", "plain", "fill" or "read"."""
        if self.launches == 0:
            return "first"
        if (rows.data_ptr(), rows.shape[0]) != self.rows or \
                dataclasses.replace(sc, om_r=0.0, om_i=0.0) != self.fixed:
            raise ValueError("N1 memo: the rows or the scalars other than "
                             "omega are not the first launch's")
        if math.copysign(1.0, sc.om_r) != self.sign:
            return "plain"
        if self.launches == 1:
            return "fill"
        return "read" if self.n else "plain"

    def place(self, budget: int) -> int:
        """The integrals' places from the first launch's panel counts: the
        prefix whose places total at most ``budget`` panels, and the memo
        for it; returns the integrals memoised (0: none, nothing
        allocated).  Under ``layer.assembly.plan``."""
        with span("assembly.plan"):
            cum = torch.cumsum(self.panels, 0, dtype=torch.int64)
            self.panels = None
            n = torch.searchsorted(cum, torch.full(
                (1,), budget, dtype=torch.int64, device=cum.device),
                right=True)[0]
            total = cum[(n - 1).clamp(min=0)] * (n > 0)
            n, total = host_read(torch.Tensor.tolist, torch.stack([n, total]))
            if n == 0:
                return 0
            rd = record_doubles(self.fixed.order)
            used = total * (rd + 2)
            alloc = max(used, math.ceil(MEMO_GROWTH ** math.ceil(
                math.log(used, MEMO_GROWTH))))
            buf = torch.empty(alloc, dtype=torch.float64, device=cum.device)
            self.rec, self.keys = buf[:total * rd], buf[total * rd:used]
            self.cum = cum[:n]
            self.nrec = torch.empty(n, dtype=torch.int32, device=cum.device)
            self.n, self.bytes = n, 8 * alloc
            return n

    def done(self, route: str, rows, sc: adaptive.Scalars, panels):
        """Keeps what a launch of ``route`` leaves for the next."""
        if route == "first":
            self.rows = (rows.data_ptr(), rows.shape[0])
            self.fixed = dataclasses.replace(sc, om_r=0.0, om_i=0.0)
            self.sign = math.copysign(1.0, sc.om_r)
            self.panels = panels
        self.launches += 1
        self.last = route


def _launch(rows, m, sc: adaptive.Scalars, memo: Memo | None = None,
            mode: int = PLAIN):
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
    # the slots' work counter: the kernel hands out integrals from it; a
    # memo launch's two node counts after it
    nxt = torch.zeros(1 if mode == PLAIN else 3, dtype=torch.int64,
                      device=dev)
    ptrs = (0, 0, 0, 0, 0, 0)
    if mode != PLAIN:
        if lib.adaptive_record_doubles(sc.order) != record_doubles(sc.order):
            raise RuntimeError("adaptive kernel: the memo's record size "
                               "differs from the library's")
        ptrs = (memo.rec.data_ptr(), memo.keys.data_ptr(),
                memo.cum.data_ptr(), memo.nrec.data_ptr(), memo.n,
                nxt[1:].data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.adaptive_launch(rows.data_ptr(), m.data_ptr(), n,
                                  scal.ctypes.data, sc.order,
                                  sc.max_subdivide, out.data_ptr(),
                                  panels.data_ptr(), miller.data_ptr(),
                                  nxt.data_ptr(), stream, info.ctypes.data,
                                  mode, *ptrs)
    if err != 0:
        raise RuntimeError(f"adaptive kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    LAST_LAUNCH.clear()
    LAST_LAUNCH.update(zip(_SHAPE_KEYS, map(int, info)))
    if mode != PLAIN:
        memo.stats.append(nxt[1:])
    return out, panels, miller


def integrate(rows, m, sc: adaptive.Scalars, memo: Memo | None = None):
    """One adaptive integral per row of ``rows`` ((n, 4) float64 pair rows,
    ``adaptive.pair_rows``) with moment ``m`` ((n,) int32) at the scalars
    ``sc``: (values (n, 2) float64 [re, im], panels (n,) int32, Miller steps
    (n,) int64).  On a CUDA tensor kernel N1 (one launch), on a CPU tensor
    the plain version.  ``memo``: a ``Memo`` that this call's launch takes
    its route from and leaves its state in, where the call is one of a
    sequence on the same rows (a solve's assemblies); ignored on the
    CPU."""
    adaptive.gk_rule(sc.order)
    n = rows.shape[0]
    if rows.dtype != torch.float64 or tuple(rows.shape) != (n, 4) \
            or m.dtype != torch.int32 or tuple(m.shape) != (n,) \
            or m.device != rows.device:
        raise ValueError(
            f"adaptive integrals: rows must be (n, 4) float64 and m (n,) "
            f"int32 on one device, got {rows.dtype} {tuple(rows.shape)} on "
            f"{rows.device}, {m.dtype} {tuple(m.shape)} on {m.device}")
    if not rows.is_cuda:
        return adaptive.integrate_ref(rows, m, sc)
    rows, m = rows.contiguous(), m.contiguous()
    if memo is None:
        return _launch(rows, m, sc)
    route = memo.route(rows, sc)
    if route == "fill" and not memo.place(memo_budget(rows.device,
                                                      sc.order)):
        route = "plain"
    mode = {"fill": FILL, "read": READ}.get(route, PLAIN)
    out = _launch(rows, m, sc, memo=memo if mode != PLAIN else None,
                  mode=mode)
    memo.done(route, rows, sc, out[1])
    return out
