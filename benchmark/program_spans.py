"""The port's own spans in a device trace: where the device's idle time
begins, where the host blocks on the card, and where device operations are
launched, by the program's layer.

The port marks its layers with ``bpt_tpu_torch.utils.profiling.span``
(``record_function`` ranges named ``bpt.*``, recorded while its spans are
on).  ``ProgramTrace`` is ``benchmark.tracing.Trace``, whose readings it
leaves as they are, that also keeps

- ``program_spans``: every ``bpt.*`` user annotation, (name, start us, end
  us, thread);
- ``syncs``: the CUDA runtime calls that block the host
  (``SYNC_CALLS``: a stream, device or event synchronize and a synchronous
  ``cudaMemcpy``; torch's blocking copies between host and card end in
  ``cudaStreamSynchronize``), (name, start us, thread);

and attributes three things to the spans a thread was in when each
happened, the innermost and every span around it: each idle gap of the
device, at its start (the main thread's spans); each sync call; each device
operation, at the runtime call that launched it (by correlation id).  An
event of another thread (autograd runs a card's backward on a thread of its
own) counts for the main thread's spans at its time and for its own
thread's.

The harness's traced window (``benchmark.tracing.capture``) runs with the
port's spans off.  ``program_trace(ctx)`` therefore traces a second window
of the cell's traffic right after it, as long, with the spans on, once per
run; the readers of ``benchmark/metrics/`` read that window.  It prints one
table of the program's spans to standard error and returns None outside a
traced run or where the port has no spans.
"""

from __future__ import annotations

import bisect
import inspect
import json
import os
import re
import sys
import tempfile
import time
from typing import Callable

import torch

from benchmark.tracing import Trace

PREFIX = "bpt."
SYNC_CALLS = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize|cudaEventSynchronize|cudaMemcpy)"
                        r"(_ptsz|_ptds)?$")
QUANTITIES = ("idle_ms", "syncs", "ops")
EPS_US = 0.01  # a child span's end may round past its parent's in the trace's microseconds


class _Nest:
    """The properly nested spans of one thread: the innermost one at a time
    and its ancestors."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda s: (s[1], -s[2]))
        self.starts = [s[1] for s in self.spans]
        self.parent: list = []
        stack: list = []
        for i, (_, a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][2] < b - EPS_US:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def names_at(self, t: float) -> set:
        """The names of the spans that hold time ``t``."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0 and t > self.spans[i][2]:
            i = self.parent[i]  # a span that holds t and began before span i holds span i
        out = set()
        while i is not None and i >= 0:
            out.add(self.spans[i][0])
            i = self.parent[i]
        return out


class ProgramTrace(Trace):
    def __init__(self, events: list):
        super().__init__(events)
        self.program_spans: list = []
        self.syncs: list = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name, ts = e.get("cat", ""), e.get("name", ""), float(e.get("ts", 0.0))
            if not self.t0 <= ts <= self.t1:
                continue
            if cat == "user_annotation" and name.startswith(PREFIX):
                self.program_spans.append((name, ts, ts + float(e.get("dur", 0.0)), e.get("tid")))
            elif cat == "cuda_runtime" and SYNC_CALLS.match(name):
                self.syncs.append((name, ts, e.get("tid")))
        threads: dict = {}
        for s in self.program_spans:
            threads.setdefault(s[3], []).append(s)
        self._nests = {tid: _Nest(spans) for tid, spans in threads.items()}
        self._empty = _Nest([])
        self._attributed: dict | None = None

    def count(self, name: str) -> int:
        """The spans ``name`` of every thread."""
        return sum(1 for s in self.program_spans if s[0] == name)

    def _names(self, t: float, tid=None) -> set:
        names = self._nests.get(self.main_tid, self._empty).names_at(t)
        if tid is not None and tid != self.main_tid and tid in self._nests:
            names |= self._nests[tid].names_at(t)
        return names

    def attributed(self) -> dict:
        """{span name: {"idle_ms", "syncs", "ops"}}: the device's idle ms
        begun inside the span, the sync calls made inside it and the device
        operations launched inside it, each summed over its spans."""
        if self._attributed is not None:
            return self._attributed
        out: dict = {}

        def add(names, key, value):
            for n in names:
                out.setdefault(n, dict.fromkeys(QUANTITIES, 0.0))[key] += value

        prev = self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > prev:
                add(self._names(prev), "idle_ms", (a - prev) / 1e3)
            prev = max(prev, b)
        for _, ts, tid in self.syncs:
            add(self._names(ts, tid), "syncs", 1)
        for op in self.ops:
            launch = self.launch.get(op.corr)
            if launch is not None:
                add(self._names(launch[1], launch[0]), "ops", 1)
        self._attributed = out
        return out

    def per_unit(self, quantity: str, spans: tuple, unit: str) -> float | None:
        """``quantity`` ("idle_ms", "syncs" or "ops") inside the spans named
        ``spans`` (which never hold one another), over the spans ``unit``;
        None where there is no ``unit`` span."""
        n = self.count(unit)
        if not n:
            return None
        got = self.attributed()
        return sum(got.get(s, {}).get(quantity, 0.0) for s in spans) / n

    def table(self) -> str:
        """One line a span name: count, total ms, self ms (less its child
        spans of the same thread), idle ms begun inside, syncs, device
        operations."""
        total: dict = {}
        self_us: dict = {}
        for nest in self._nests.values():
            for i, (name, a, b, _) in enumerate(nest.spans):
                total[name] = total.get(name, 0.0) + (b - a)
                self_us[name] = self_us.get(name, 0.0) + (b - a)
                p = nest.parent[i]
                if p is not None:
                    parent = nest.spans[p][0]
                    self_us[parent] = self_us.get(parent, 0.0) - (b - a)
        got = self.attributed()
        lines = [f"{'program span':<22}{'count':>8}{'total ms':>12}{'self ms':>12}{'idle ms':>12}{'syncs':>8}"
                 f"{'device ops':>12}"]
        for name in sorted(total):
            g = got.get(name, dict.fromkeys(QUANTITIES, 0.0))
            lines.append(f"{name:<22}{self.count(name):>8}{total[name] / 1e3:>12.3f}{self_us[name] / 1e3:>12.3f}"
                         f"{g['idle_ms']:>12.3f}{int(g['syncs']):>8}{int(g['ops']):>12}")
        return "\n".join(lines)


def port_switch():
    """The port's ``spans_on``, or None where the port has no spans."""
    from bpt_tpu_torch.utils import profiling

    return getattr(profiling, "spans_on", None)


def capture(window: Callable):
    """(ProgramTrace, ``window()``'s result): the window run with the port's
    spans on, under ``torch.profiler`` inside a ``record_function("window")``
    range (``benchmark.tracing.capture`` with the spans on)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with port_switch()(), profile(activities=activities) as prof:
        with record_function("window"):
            out = window()
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return ProgramTrace(events), out


def _work(units: list) -> tuple[int, str]:
    """The steps of a train window or the frames or requests of another."""
    if units and "steps" in units[0]:
        return sum(u["steps"] for u in units), "steps"
    return len(units), "requests"


def program_trace(ctx) -> ProgramTrace | None:
    """The ProgramTrace of a window of the cell's traffic as long as the
    traced one, run after it with the port's spans on; made once a run and
    kept on ``ctx``.  None outside a traced run or where the port has no
    spans.  The benchmark's host spans recorded meanwhile are taken out
    again; a viewer's requests in it are not sampled for the check."""
    if ctx.trace is None or port_switch() is None:
        return None
    if getattr(ctx, "program_trace", None) is None:
        kind = ctx.kind
        keep = "keep" in inspect.signature(kind.unit).parameters
        records = list(ctx.spans.records)

        def window():
            units, t0 = [], time.perf_counter()
            while time.perf_counter() - t0 < ctx.window_s:
                units.append(kind.unit(keep=False) if keep else kind.unit())
            return units, time.perf_counter() - t0

        try:
            trace, (units, seconds) = capture(window)
        finally:
            ctx.spans.records[:] = records
        n, what = _work(units)
        m, _ = _work(ctx.units)
        print(f"the port's spans on: {n} {what} in {seconds!r} s ({n / seconds!r} a second; the traced window "
              f"with them off: {m / ctx.window_s!r})\n{trace.table()}", file=sys.stderr)
        ctx.program_trace = trace
    return ctx.program_trace
