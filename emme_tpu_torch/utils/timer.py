"""The program's spans, and the named-section wall-clock timer of the
reference (include/Timer.h:10-35, src/Timer.cpp:8-71).

``span(name)`` is the program's one tracing primitive.  While a torch
profiler records in the process it opens
``torch.profiler.record_function("layer." + name)``: a range on kineto's host
timeline, the clock of the profiler's CUPTI device events, so that a trace
puts every idle gap of the device under the span that was open when the gap
began.  With no profiler recording it makes one check and nothing else.
``SPANS`` names every span the program opens.  Any ``torch.profiler`` trace
shows them; for ``nsys``, run the program inside
``torch.autograd.profiler.emit_nvtx()``, which sends the same ranges out as
NVTX ranges.  ``host_read`` takes every blocking device-to-host read of an
eigen or a PIC request, under the span ``layer.host_read``.

``Timer`` and ``section`` keep the reference's table of host-clock seconds
(``driver.run``'s report, ``eigen_timers``, ``pic_timers``); a section opens
no span.  Counterpart of ``emme_tpu/utils/timer.py``."""

from __future__ import annotations

import contextlib
import threading
import time

import torch

# Every span the program opens (``span`` prefixes "layer.").  The benchmark's
# own spans (``portbench/tracing.py``) wrap entry points under other names;
# no name here nests inside a span of the same name.
SPANS = (
    "layer.driver.params",     # driver.solve_once_eigen: params.from_config
    "layer.driver.guard",      # driver.solve_once_eigen: the quadrature guard
    "layer.solve.setup",       # a solve's grid, coefficients, tiers, plan
    "layer.assembly.plan",     # an assembly plan, or N1's memo's places
    "layer.assembly.pairs",    # an assembly's kernel values (K1 and around)
    "layer.assembly.place",    # writing them into the operator
    "layer.assembly.electron",  # exact EM: electron closed forms, A_par diag
    "layer.linalg.step",       # a Newton step's linear algebra
    "layer.linalg.vector",     # the null vector after the loop
    "layer.linalg.arnoldi",    # the banded shift-invert Arnoldi stage
    "layer.survey.secant",     # a multi-shift survey's M and M' a shift
    "layer.survey.lu",         # its batched LU of the shifts' M
    "layer.survey.sweep",      # its batched Arnoldi sweep
    "layer.survey.ritz",       # its Hessenbergs' read, the host eigensolves
    "layer.host_read",         # a blocking device-to-host read
    "layer.pic.setup",         # cuda_pic.run up to K3's launch
    "layer.pic.params",        # its FusedStep: the scalar block's reads
    "layer.pic.qn",            # its quasi-neutrality coefficient
    "layer.pic.arrs",          # its initial state, marker arrays and field
    "layer.pic.k3",            # K3's launch (K2's step loop on that path)
    "layer.pic.state",         # cuda_pic.arrs_to_state
)

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager: the span ``layer.<name>`` while a torch profiler
    records, else a no-op."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function("layer." + name)


def host_read(read, *args):
    """``read(*args)``, a blocking device-to-host read, under the span
    ``layer.host_read``."""
    with span("host_read"):
        return read(*args)


class Timer:
    """Thread-safe: the driver's parallel scan mode (scan_workers > 1)
    enters/exits sections concurrently from worker threads; all mutation of
    the shared accumulators is guarded by one lock, and a lost start/pause
    race degrades to a no-op instead of a KeyError (which would otherwise be
    mis-captured as a scan-point failure by the per-point fault tolerance)."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self.entries: list[str] = []
        self._acc: dict[str, float] = {}
        self._started: dict[str, float] = {}
        self._current: str | None = None
        self._lock = threading.RLock()

    @classmethod
    def get_timer(cls) -> "Timer":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = Timer()
            return cls._instance

    def start_timing(self, name: str):
        with self._lock:
            if name not in self._acc:
                self._acc[name] = 0.0
                self.entries.append(name)
            self._started[name] = time.perf_counter()
            self._current = name

    def pause_timing(self, name: str | None = None):
        with self._lock:
            name = name if name is not None else self._current
            t0 = self._started.pop(name, None)
            if t0 is not None:
                self._acc[name] += time.perf_counter() - t0

    def pause_and_start(self, name: str):
        with self._lock:
            self.pause_timing()
            self.start_timing(name)

    def reset(self):
        with self._lock:
            self.entries.clear()
            self._acc.clear()
            self._started.clear()
            self._current = None

    def report(self) -> str:
        with self._lock:
            return self._report_locked()

    def _report_locked(self) -> str:
        if not self.entries:
            return "(no timings)"
        w = max(len(n) for n in self.entries)
        inner = w + 18
        border = "+" + "-" * inner + "+"
        sep = "+" + "-" * (w + 2) + "+" + "-" * 15 + "+"
        lines = [border, "|" + " Time consumption".ljust(inner) + "|", sep]
        for n in self.entries:
            lines.append(f"| {n:<{w}} | {self._acc[n]:<12.6g}s|")
        lines.append(sep)
        return "\n".join(lines)

    def print(self):
        print(self.report())

    def timings(self) -> dict[str, float]:
        with self._lock:
            return dict(self._acc)


def sync(t) -> None:
    """Wait for the device of tensor ``t`` where it is a CUDA device: what a
    timed section ends with so that its seconds are its work's and not its
    enqueue's.  Nothing to wait for on the CPU."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


class section:
    """Context manager: ``with section("Iteration"): ...`` accumulates the
    body's host-clock seconds in the ``Timer`` table.  It never synchronizes
    the device: a section that must hold its device work ends with an
    explicit ``torch.cuda.synchronize()`` (``eigen.solve(timed=True)``,
    ``pic.run_timed``)."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        Timer.get_timer().start_timing(self.name)
        return self

    def __exit__(self, *exc):
        Timer.get_timer().pause_timing(self.name)
        return False
