"""The traced run's device trace: ``torch.profiler`` over the window, read
back from its Chrome trace.

The device operations (kernels, copies, memsets), the host's runtime calls
that launched them (by correlation id, with their thread and start), and
the benchmark's host spans (``record_function`` ranges) are all that the
per-layer readers and the breakdown use.  The trace file is written to the
run's temporary directory and deleted once read.

An untraced run of a cell with an end-to-end metric from the device trace
(``source`` ``device_trace``) runs its whole window under ``busy_capture``:
the device's operations alone, their busy time and the port's launches.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import Callable, NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("window", "job", "sync", "request", "render_sample", "batch_step", "display")
_K = re.compile(r"(trace|phase)_kernel(?:_textured)?<\s*(true|false)")
_KEY = re.compile(r"(?<![A-Za-z0-9_])key_kernel(?![A-Za-z0-9_])")


class Op(NamedTuple):
    name: str
    start: float  # us
    dur: float  # us
    corr: int | None


def kind_of(name: str) -> str | None:
    """"k1", "k1_grad", "k2", "k2_grad", "key" or "sort" for the port's
    kernels and the sort between phases, else None."""
    m = _K.search(name)
    if m:
        return ("k1" if m.group(1) == "trace" else "k2") + ("_grad" if m.group(2) == "true" else "")
    if _KEY.search(name):
        return "key"
    if "sort" in name.lower() and "key_box_kernel" not in name:
        return "sort"
    return None


class Trace:
    def __init__(self, events: list):
        self.ops: list[Op] = []
        self.launch: dict = {}  # correlation id: (host thread, start us) of the runtime call
        self.spans: list = []  # (name, start us, end us, tid)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, args = e.get("cat", ""), e.get("args") or {}
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.ops.append(Op(e.get("name", ""), ts, dur, args.get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver") and args.get("correlation") is not None:
                self.launch[args["correlation"]] = (e.get("tid"), ts)
            elif cat == "user_annotation" and e.get("name") in HOST_SPANS:
                self.spans.append((e["name"], ts, ts + dur, e.get("tid")))
        windows = [s for s in self.spans if s[0] == "window"]
        if not windows:
            raise RuntimeError("the trace holds no 'window' span")
        _, self.t0, self.t1, self.main_tid = windows[0]
        self.ops = sorted((op for op in self.ops if self.t0 <= op.start <= self.t1), key=lambda op: op.start)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, in us."""
        out: list = []
        for op in self.ops:
            a, b = op.start, min(op.start + op.dur, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device(self, kind: str) -> tuple[float, int]:
        """(device ms, operations) of the operations of ``kind_of`` ``kind``."""
        ops = [op for op in self.ops if kind_of(op.name) == kind]
        return sum(op.dur for op in ops) / 1e3, len(ops)

    def device_where(self, pred: Callable[[Op], bool]) -> tuple[float, int]:
        ops = [op for op in self.ops if pred(op)]
        return sum(op.dur for op in ops) / 1e3, len(ops)

    def off_main_thread(self, op: Op) -> bool:
        """Whether the host thread that launched ``op`` is not the one that
        runs the window (autograd runs a CUDA graph's backward on a thread of
        its own)."""
        tid = self.launch.get(op.corr, (None, 0.0))[0]
        return tid is not None and tid != self.main_tid

    def main_spans(self, name: str) -> list:
        """[(start us, end us)] of the main thread's spans ``name``, in order."""
        return sorted((a, b) for n, a, b, tid in self.spans if n == name and tid == self.main_tid)

    def request_spans(self, units: list, view) -> list:
        """The spans of the window's requests (``units``, in order) at ``view``."""
        spans = self.main_spans("request")
        if len(spans) != len(units):
            raise RuntimeError(f"the trace holds {len(spans)} request spans for {len(units)} requests")
        return [s for s, u in zip(spans, units) if u.get("view") == view]

    def device_launched_in(self, kind: str, spans: list) -> tuple[float, int]:
        """(device ms, operations) of the operations of ``kind_of`` ``kind``
        that the main thread launched inside one of ``spans``."""

        def inside(op):
            tid, ts = self.launch.get(op.corr, (None, 0.0))
            return tid == self.main_tid and any(a <= ts <= b for a, b in spans)

        return self.device_where(lambda op: kind_of(op.name) == kind and inside(op))

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time, summed by name."""
        sums: dict = {}
        for op in self.ops:
            name = op.name[:160]
            sums[name] = sums.get(name, 0.0) + op.dur / 1e6
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host span, seconds]]: the device's idle time inside the window,
        summed by the innermost benchmark span the main thread was in when
        each gap began ("none" outside every span but the window)."""
        spans = sorted((s for s in self.spans if s[3] == self.main_tid and s[0] != "window"), key=lambda s: s[1])
        starts = [s[1] for s in spans]
        sums: dict = {}
        prev = self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                label = "none"
                # the latest-starting span that contains the gap's start is the innermost; the spans nest
                # at most a few deep, so a few steps back reach the outermost
                last = bisect.bisect_right(starts, prev) - 1
                for i in range(last, max(last - 8, -1), -1):
                    if prev < spans[i][2]:
                        label = spans[i][0]
                        break
                sums[label] = sums.get(label, 0.0) + (a - prev) / 1e6
            prev = max(prev, b)
        return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


class Busy(NamedTuple):
    seconds: float  # the union of the device operations' intervals
    launches: dict  # ``kind_of``: operations of the port's kernels


def busy_capture(window: Callable, device: torch.device):
    """(Busy, ``window()``'s result): the window under ``torch.profiler``
    recording the device's operations alone (on a card its kernels, copies
    and memsets by CUPTI; on the CPU its operators), read from the
    profiler's events without a trace file."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        out = window()
        if cuda:
            torch.cuda.synchronize()
    want = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    spans, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want or getattr(e, "is_user_annotation", lambda: False)():
            continue
        a = e.start_ns()
        spans.append((a, a + e.duration_ns()))
        kind = kind_of(e.name())
        if kind is not None:
            launches[kind] = launches.get(kind, 0) + 1
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    return Busy(busy / 1e9, launches), out


def capture(window: Callable):
    """(Trace, ``window()``'s result): the window run under
    ``torch.profiler`` inside a ``record_function("window")`` range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            out = window()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events), out
