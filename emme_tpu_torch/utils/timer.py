"""Named-section wall-clock timer (reference include/Timer.h:10-35,
src/Timer.cpp:8-71): start/pause/pause_and_start accumulation with an ASCII
table report.  Counterpart of ``emme_tpu/utils/timer.py``.  On a CUDA build
``section`` also brackets its body with an NVTX range, so the sections show
on a profiler's timeline."""

from __future__ import annotations

import threading
import time

import torch


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
    """Context manager: ``with section("Iteration"): ...``

    Besides the wall-clock accumulation it pushes an NVTX range on a CUDA
    build, so the section shows up on the device timeline when a profiler
    is capturing.  It never synchronizes the device: a section that must
    hold its device work ends with an explicit ``torch.cuda.synchronize()``
    (``eigen.solve(timed=True)``, ``pic.run_timed``)."""

    def __init__(self, name: str):
        self.name = name
        self._range = False

    def __enter__(self):
        Timer.get_timer().start_timing(self.name)
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)
            self._range = True
        return self

    def __exit__(self, *exc):
        if self._range:
            torch.cuda.nvtx.range_pop()
            self._range = False
        Timer.get_timer().pause_timing(self.name)
        return False
