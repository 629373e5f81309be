"""Profiling: timers, rays/s accounting, device traces (port of
``bpt_tpu.utils.profiling``).

The reference's instruments are a stats.js FPS meter and overlay counters
(SURVEY.md §5).  Here: a wall-clock section timer with ray-throughput
accounting, and a thin wrapper over ``torch.profiler`` for device traces
(Chrome trace JSON, viewable in Perfetto or TensorBoard).  Importing this
module initialises no CUDA.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


@dataclass
class FrameStats:
    """Rolling per-frame stats — the stats.js analog."""

    times: List[float] = field(default_factory=list)
    window: int = 60

    def tick(self, seconds: float) -> None:
        self.times.append(seconds)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def rays_per_second(self, rays_per_frame: int) -> float:
        if not self.times:
            return 0.0
        return rays_per_frame * len(self.times) / sum(self.times)


class Profiler:
    """Named section timing with ray accounting.

    with prof.section("render", rays=H*W*bounces):
        out = step(...)

    Where CUDA is in use, a section synchronises the card at its end, so
    that it times the work it launched, not its launch."""

    def __init__(self) -> None:
        self.sections: Dict[str, List[float]] = {}
        self.rays: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, rays: Optional[int] = None):
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.sections.setdefault(name, []).append(dt)
        if rays is not None:
            self.rays[name] = rays

    def summary(self) -> str:
        lines = []
        for name, times in self.sections.items():
            mean = sum(times) / len(times)
            line = f"{name}: {mean*1000:.2f} ms avg over {len(times)}"
            if name in self.rays:
                line += f", {self.rays[name]/mean/1e6:.1f} Mrays/s"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a trace of the host and, where CUDA is available, the card
    into ``logdir`` as a Chrome trace file (``*.pt.trace.json``):
    ``with device_trace('traces') as prof: ...``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def event_ms(fn, iters: int = 3, warmup: int = 1, device=None) -> float:
    """Mean ms per call of ``fn()`` after ``warmup`` calls: CUDA events
    around the ``iters`` calls on a CUDA ``device``, the host clock
    otherwise (``device`` None: CUDA when it is initialised)."""
    for _ in range(warmup):
        fn()
    cuda = torch.device(device).type == "cuda" if device is not None else torch.cuda.is_initialized()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters
