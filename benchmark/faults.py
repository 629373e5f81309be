"""Faults planted in the port's timed path, each a context manager that
patches one of the port's functions and restores it: what the check must
judge not correct.  ``benchmark/tests/test_bench_harness.py`` plants each
in a small run on the CPU; ``benchmark.readings`` reads them on the card."""

from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def adam_leaves_state():
    """A step that returns its state unchanged: Adam's update does nothing."""
    return patched(importlib.import_module("torch.optim.adam"), "adam", lambda *args, **kwargs: None)


def half_the_frames():
    """Half of the batch left out, the mean taken over the rest: each render
    of a train job averages the first half of its frames."""
    from bpt_tpu_torch.diff import inverse

    full = inverse.render_avg

    def half(scene, camera, cfg, size, frames, *args, **kwargs):
        return full(scene, camera, cfg, size, list(frames)[: max(len(frames) // 2, 1)], *args, **kwargs)

    return patched(inverse, "render_avg", half)


def half_the_samples():
    """Half of the batch left out, the mean taken over the rest: a request
    renders half its samples and displays their mean."""
    from bpt_tpu_torch.renderer import ProgressiveRenderer

    full = ProgressiveRenderer.render
    return patched(ProgressiveRenderer, "render",
                   lambda self, camera, spp, batch=8: full(self, camera, max(spp // 2, 1), batch))


def display_altered():
    """An answer altered where it is produced: the display 0.1% darker."""
    from bpt_tpu_torch import renderer

    full = renderer.screen_output
    return patched(renderer, "screen_output", lambda *args, **kwargs: full(*args, **kwargs) * 0.999)


FAULTS = {f.__name__: f for f in (adam_leaves_state, half_the_frames, half_the_samples, display_altered)}
