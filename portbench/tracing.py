"""Spans around the program's layers and the reading of a traced window.

``Spans`` installs, from the benchmark's own files, a wrapper around each
named entry point of a layer: a ``torch.profiler.record_function`` span
(``layer.<name>``) and a count of its calls.  A wrapper whose span never
fires in the window fails the traced run: a renamed entry point never
reads as zero.  A wrapper may also keep what a roofline needs of a call
(its shapes, and in set-up a small sample of its inputs).

``summarize`` reduces the profiler's events over the window: the device's
busy time (the union of kernel, copy and set intervals), each kernel's
time with the host time it was launched at, each span's intervals, and the
breakdown the result line carries.
"""

from __future__ import annotations

import importlib
from collections import defaultdict
from dataclasses import dataclass

import numpy as np


def record_function(name: str):
    import torch
    return torch.profiler.record_function(name)


def profiler(device):
    """A profiler of the host and, on a card, of the device."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


class Spans:
    """Wrappers around ``(module, attribute, span, keep)`` entry points:
    ``keep(phase, args, kwargs, result)``, when given, records what a
    reader needs of a call."""

    def __init__(self, table):
        self.table = table
        self.calls = defaultdict(int)
        self.kept = defaultdict(list)
        self.phase = "setup"
        self._saved = []

    def install(self):
        for mod_name, attr, span, keep in self.table:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, span, keep))

    def uninstall(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def _wrap(self, fn, span, keep):
        def wrapped(*args, **kwargs):
            if self.phase == "window":
                self.calls[span] += 1
            with record_function(f"layer.{span}"):
                out = fn(*args, **kwargs)
            if keep is not None:
                got = keep(self.phase, args, kwargs, out)
                if got is not None:
                    self.kept[(span, self.phase)].append(got)
            return out
        return wrapped

    def check_fired(self):
        silent = sorted({s for _m, _a, s, _k in self.table
                         if self.calls[s] == 0})
        if silent:
            raise RuntimeError(f"spans that never fired in the window: "
                               f"{silent} (an entry point was renamed?)")


def _union_length(starts, ends) -> float:
    order = np.argsort(starts)
    total, cur_s, cur_e = 0, None, None
    for s, e in zip(starts[order], ends[order]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return float(total)


def summarize(prof, t0: float, t1: float) -> dict:
    """The window's device work and spans from ``prof``'s events.

    Times are ns on the profiler's clock.  The window is the profiler's
    own span from start to stop."""
    res = prof.profiler.kineto_results
    events = res.events()
    runtime, ops = {}, {}
    spans = defaultdict(list)
    dev = []
    kinds = set()
    for e in events:
        kind = str(e.device_type())
        if kind.endswith("CPU"):
            cid = e.correlation_id()
            name = e.name()
            if cid:
                (runtime if name.startswith("cu") else ops)[cid] = \
                    e.start_ns()
            if name.startswith("layer.") or name.startswith("portbench."):
                spans[name].append((e.start_ns(), e.start_ns()
                                    + e.duration_ns()))
        elif e.duration_ns() > 0 and not _annotation(e):
            dev.append((e.name(), e.start_ns(), e.duration_ns(),
                        e.correlation_id(), e.linked_correlation_id()))
        else:
            kinds.add(e.name()[:40])
    w0 = res.trace_start_ns()
    w1 = max([b for v in spans.values() for _a, b in v]
             + [d[1] + d[2] for d in dev] + [w0])
    window_ns = max(w1 - w0, 1)
    names = [d[0] for d in dev]
    starts = np.array([d[1] for d in dev], dtype=np.int64)
    durs = np.array([d[2] for d in dev], dtype=np.int64)
    # the host time a device operation was launched at: its runtime call
    # (same correlation id), else the operator that made it (linked id)
    launch = np.array([runtime.get(d[3], runtime.get(d[4], ops.get(d[4], -1)))
                       for d in dev], dtype=np.int64)
    busy_ns = _union_length(starts, starts + durs) if len(dev) else 0.0
    copy = np.array([n.startswith(("Memcpy", "Memset")) for n in names],
                    dtype=bool)

    by_name = defaultdict(float)
    for n, d in zip(names, durs):
        by_name[n] += d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps between device intervals, by the innermost span open on the
    # host when the gap began
    idle = defaultdict(float)
    if len(dev):
        order = np.argsort(starts)
        s_sorted, e_sorted = starts[order], (starts + durs)[order]
        run_end = np.maximum.accumulate(e_sorted)
        gaps_at = run_end[:-1]
        gaps = s_sorted[1:] - gaps_at
        table = {n: (v[np.argsort(v[:, 0])] if len(v) else v)
                 for n, v in ((n, np.array(v, dtype=np.int64))
                              for n, v in spans.items())}
        for g0, g in zip(gaps_at, gaps):
            if g > 0:
                idle[_innermost(table, g0)] += g
        idle["before first kernel"] += max(0, int(s_sorted[0]) - w0)
        idle["after last kernel"] += max(0, w1 - int(run_end[-1]))
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": window_ns * 1e-9, "busy_s": busy_ns * 1e-9,
        "names": names, "starts": starts, "durs": durs, "launch": launch,
        "copy": copy, "spans": {k: np.array(v, dtype=np.int64)
                                for k, v in spans.items()},
        "skipped_kinds": sorted(kinds),
        "launch_found": int((launch >= 0).sum()),
        "breakdown": {"device_ops": [[n, d * 1e-9] for n, d in top],
                      "idle_gaps": [[n, d * 1e-9] for n, d in gaps_top]},
    }


def _annotation(e) -> bool:
    """A span's image on the device's timeline (the profiler draws each
    host span there too): not work of the device."""
    name = e.name()
    kind = getattr(e, "activity_type", None)
    return (name.startswith(("layer.", "portbench."))
            or (kind is not None and "annotation" in str(kind()).lower()))


def _innermost(table, t) -> str:
    """The name of the latest-starting span that holds ``t`` (spans of one
    name do not overlap)."""
    best, best_start = "outside the harness's spans", None
    for name, iv in table.items():
        k = int(np.searchsorted(iv[:, 0], t, side="right")) - 1
        if k >= 0 and iv[k, 1] >= t and (best_start is None
                                         or iv[k, 0] > best_start):
            best, best_start = name, iv[k, 0]
    return best


def inside(times, intervals) -> np.ndarray:
    """Which of ``times`` fall inside any of ``intervals`` (k, 2)."""
    if len(intervals) == 0:
        return np.zeros(len(times), dtype=bool)
    iv = intervals[np.argsort(intervals[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    k = np.searchsorted(iv[:, 0], times, side="right") - 1
    ok = k >= 0
    out = np.zeros(len(times), dtype=bool)
    out[ok] = times[ok] <= ends[k[ok]]
    return out


@dataclass
class Context:
    """What a per-layer reader reads."""
    cell: object
    entry: object
    records: list
    summary: dict
    spans: Spans
    window_s: float

    def kernels(self, substring: str):
        """Indices of the device kernels whose name holds ``substring``."""
        return [i for i, n in enumerate(self.summary["names"])
                if substring in n]
