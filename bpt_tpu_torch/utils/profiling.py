"""Profiling: the program's spans, device traces and CUDA-event timing
(port of ``bpt_tpu.utils.profiling``'s trace context).

``span(name)`` marks where a layer's work happens.  While spans are on
(``spans_on()``; ``device_trace`` turns them on for its duration) it opens
a ``torch.profiler.record_function`` range, which the profiler records on
the timeline of the device's operations and the CUDA runtime calls, so a
span shares the device trace's clock.  While they are off it tests one
module flag and returns a shared no-op context: no range, no clock read,
no allocation.  The spans, each at the work it names:

- ``bpt.optim.step`` (``diff.inverse.optimize``, one Adam step) and its
  children ``bpt.optim.forward`` (the scene, the render, the loss),
  ``bpt.optim.backward`` (``loss.backward()``) and ``bpt.optim.update``
  (Adam and the clip);
- ``bpt.replay.forward`` and ``bpt.replay.backward``
  (``kernels.megakernel._PathReplay``; the backward runs on autograd's
  thread on a card) and ``bpt.replay.compose`` (``compose_deferred``);
- ``bpt.renderer.frame`` (``ProgressiveRenderer.render_sample``), its child
  ``bpt.renderer.camera`` (the motion test and the camera's copy),
  ``bpt.renderer.finish`` (each ``finish_frame``) and
  ``bpt.renderer.display``;
- ``bpt.staged.batch`` (``kernels.integration.staged_batch_step``'s step:
  the pool and its frames' ``finish_frame``), ``bpt.staged.pool``
  (``kernels.staged.trace_staged``) and ``bpt.staged.sort`` (the sort
  between phases);
- ``bpt.kernels.k1``, ``bpt.kernels.k2`` and ``bpt.kernels.key``: the host
  side of each launch of K1, K2 and the key kernel (packing and launch).

Frames, pools and steps are counted by their spans.  Importing this module
initialises no CUDA.
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

_ON = False  # whether span() opens a profiler range
_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("bpt.layer.part"): ...``: a ``record_function(name)``
    range while spans are on, else a shared context that does nothing."""
    if not _ON:
        return _OFF
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``; while
    spans are off the call costs the same one flag test."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def spans_on():
    """Turn the program's spans on for the duration (for every thread)."""
    global _ON
    was, _ON = _ON, True
    try:
        yield
    finally:
        _ON = was


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a trace of the host and, where CUDA is available, the card
    into ``logdir`` as a Chrome trace file (``*.pt.trace.json``), with the
    program's spans on: ``with device_trace('traces') as prof: ...``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with spans_on(), profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
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
