"""Checkpoint / resume for progressive renders and inverse-rendering runs.

Port of ``bpt_tpu.utils.checkpoint``, through ``torch.save`` and
``torch.load(weights_only=True)``.  A progressive render's resumable state
is its ``RenderState`` (the accumulation buffer and the two host counters);
a ``ProgressiveRenderer`` also draws each frame's blue-noise offsets from its
own numpy generator and detects motion against the last camera matrix, so
``save_renderer`` keeps those too: a renderer loaded from it renders the
same frames as one that never stopped.

Files hold plain containers only (dicts, lists, tuples, tensors, numbers,
strings), which is what ``weights_only=True`` accepts: the ``NamedTuple``s
are rebuilt on load.  The JAX package's Orbax and ``.npz`` back ends are
its own choices and are not ported.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_structure, tree_unflatten

from bpt_tpu_torch.renderer import ProgressiveRenderer, RenderState


def _state_dict(state: RenderState) -> dict:
    return {"accum": state.accum.detach(), "sample_counter": float(state.sample_counter),
            "frame_counter": float(state.frame_counter)}


def _state_from(d: dict) -> RenderState:
    return RenderState(accum=d["accum"], sample_counter=float(d["sample_counter"]),
                       frame_counter=float(d["frame_counter"]))


def save_render_state(path: str, state: RenderState) -> str:
    """Persist a RenderState; returns the path written."""
    torch.save(_state_dict(state), path)
    return path


def load_render_state(path: str, device=None) -> RenderState:
    """The RenderState of ``save_render_state``, its buffer on ``device``
    (default: where it was saved from)."""
    return _state_from(torch.load(path, map_location=device, weights_only=True))


def save_renderer(path: str, renderer: ProgressiveRenderer) -> str:
    """Persist what a ProgressiveRenderer needs to go on as if it had never
    stopped: its RenderState, its generator's state (PCG64's 128-bit words
    are Python ints, which the file keeps exactly) and the last camera
    matrix it saw.  The scene, config and blue noise are the caller's."""
    last = renderer._last_cam_matrix
    torch.save({"state": _state_dict(renderer.state), "rng": renderer._np_rng.bit_generator.state,
                "camera_matrix": None if last is None else torch.from_numpy(np.array(last))}, path)
    return path


def load_renderer(path: str, renderer: ProgressiveRenderer) -> ProgressiveRenderer:
    """Restore ``save_renderer``'s file into ``renderer`` (built with the same
    scene, config, size and blue noise), on the renderer's device; returns
    it."""
    d = torch.load(path, map_location=renderer.device, weights_only=True)
    state = _state_from(d["state"])
    if tuple(state.accum.shape) != (renderer.height, renderer.width, 4):
        raise ValueError(f"checkpoint of a {tuple(state.accum.shape[:2])} film, renderer is "
                         f"{(renderer.height, renderer.width)}")
    renderer.state = state
    renderer._np_rng.bit_generator.state = d["rng"]
    m = d["camera_matrix"]
    renderer._last_cam_matrix = None if m is None else m.cpu().numpy()
    return renderer


def _plain(tree: Any) -> Any:
    """``tree`` with every NamedTuple made a tuple (``weights_only`` refuses
    other classes)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def save_pytree(path: str, tree: Any) -> str:
    """Persist a nest of dicts, lists, tuples and NamedTuples of tensors and
    numbers (optimizer state, scene parameters); returns the path written."""
    torch.save(_plain(tree), path)
    return path


def load_pytree(path: str, like: Optional[Any] = None, device=None) -> Any:
    """The tree of ``save_pytree``: without ``like`` its nested dicts, lists
    and tuples as saved (a NamedTuple comes back a tuple); with ``like``, in
    ``like``'s containers, NamedTuples included.  The JAX package returns a
    flat list of leaves without ``like``; this one keeps the nesting."""
    tree = torch.load(path, map_location=device, weights_only=True)
    if like is None:
        return tree
    leaves, spec = tree_flatten(tree)
    if spec != tree_structure(_plain(like)):
        raise ValueError("the checkpoint's keys and nesting differ from like's")
    return tree_unflatten(leaves, tree_structure(like))
