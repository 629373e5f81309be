# Frozen copy of bpt_tpu_torch/core/rng.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.  blue_noise_table
# keeps only the synthesised table (it reads no file).
"""Deterministic per-pixel RNG streams (hash RNG + blue-noise decision stream).

Port of ``bpt_tpu.core.rng``, bit-exact.  Both streams are fixed-schedule:
every draw site consumes on every lane, so the stream position is a function
of (pixel, frame, site) alone and the plain integrator, the CUDA kernel and
the JAX reference all see the same numbers.

The hash works on uint32 with wrap-around.  PyTorch's CPU uint32 lacks ``+``
and ``>>``, so the state is held as int64 tensors with values in
[0, 2**32) and every step is masked with ``& 0xFFFFFFFF``; each product of
the multiplier (< 2**31) and a masked value (< 2**32) fits in int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAGIC = 1103515245
_U32 = 0xFFFFFFFF


class RngState(NamedTuple):
    """Per-lane uvec2 hash state: int64 tensors holding uint32 values."""

    sx: torch.Tensor
    sy: torch.Tensor


def frame_to_u32(frame_counter) -> int:
    """uint32 of a whole, non-negative frame counter (float or int)."""
    return int(frame_counter) & _U32


def rng_seed(frame_counter, px: torch.Tensor, py: torch.Tensor) -> RngState:
    """seed = uvec2(uFrameCounter, uFrameCounter+1) * uvec2(pixel).

    ``px``/``py`` are absolute integer pixel coordinates.  ``frame_counter``
    is a Python number (the renderer keeps its counters on the host).
    """
    f = frame_to_u32(frame_counter)
    f1 = (f + 1) & _U32
    px = px.to(torch.int64)
    py = py.to(torch.int64)
    return RngState(sx=(px * f) & _U32, sy=(py * f1) & _U32)


def rng_next(state: RngState) -> tuple[torch.Tensor, RngState]:
    """One draw of iq's hash; returns (float32 in [0, 1), new state).

    Float construction: bitcast((n >> 9) | 0x3F800000) - 1, as in the
    reference (the top 23 bits of the hash).
    """
    sx = (state.sx + 1) & _U32
    sy = (state.sy + 1) & _U32
    qx = (MAGIC * ((sx >> 1) ^ sy)) & _U32
    qy = (MAGIC * ((sy >> 1) ^ sx)) & _U32
    n = (MAGIC * (qx ^ (qy >> 3))) & _U32
    bits = (n >> 9) | 0x3F800000
    value = bits.to(torch.int32).view(torch.float32) - 1.0
    return value, RngState(sx, sy)


def rng_next2(state: RngState) -> tuple[torch.Tensor, torch.Tensor, RngState]:
    """Two draws: (a, b, new state)."""
    a, state = rng_next(state)
    b, state = rng_next(state)
    return a, b, state


# ---------------------------------------------------------------------------
# Blue-noise decision stream
# ---------------------------------------------------------------------------

class BlueNoise(NamedTuple):
    """Per-pixel decision-texel channels and a draw cursor (counts mod 4)."""

    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    a: torch.Tensor
    count: int  # draws taken so far (the same for every lane)


_bn_cache: dict = {}


def blue_noise_table(size: int = 256) -> np.ndarray:
    """(size, size, 4) float32 decision-noise table: the synthesised
    interleaved-gradient noise that the port falls back to where the
    reference's blue-noise asset is absent (the benchmark runs without it)."""
    if size in _bn_cache:
        return _bn_cache[size]
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    chans = []
    for ox, oy in ((0.0, 0.0), (97.0, 31.0), (53.0, 151.0), (211.0, 71.0)):
        v = np.modf(52.9829189 * np.modf(0.06711056 * (x + ox) + 0.00583715 * (y + oy))[0])[0]
        chans.append(v)
    out = np.stack(chans, axis=-1).astype(np.float32)
    _bn_cache[size] = out
    return out


def blue_noise_offsets(rand_vec2, size: int = 256) -> tuple[int, int]:
    """(ox, oy) = floor(rand_vec2 * size) in float32, as host integers;
    ``rand_vec2`` is a host pair (the renderer draws it with numpy)."""
    rv = np.asarray(rand_vec2, np.float32).reshape(2)
    return int(np.floor(rv[0] * np.float32(size))), int(np.floor(rv[1] * np.float32(size)))


def blue_noise_fetch(table: torch.Tensor, px: torch.Tensor, py: torch.Tensor, rand_vec2) -> BlueNoise:
    """Per-pixel decision texel at ((pixel + floor(rand_vec2*256)) mod 256)."""
    size = table.shape[0]
    ox, oy = blue_noise_offsets(rand_vec2, size)
    ix = torch.remainder(px.to(torch.int64) + ox, size)
    iy = torch.remainder(py.to(torch.int64) + oy, size)
    texel = torch.remainder(table[iy, ix], 1.0)  # gather: (..., 4)
    return BlueNoise(r=texel[..., 0], g=texel[..., 1], b=texel[..., 2], a=texel[..., 3], count=0)


def bn_next(state: BlueNoise) -> tuple[torch.Tensor, BlueNoise]:
    """Next decision value: cycles the R, G, B, A channels."""
    value = (state.r, state.g, state.b, state.a)[state.count & 3]
    return value, state._replace(count=state.count + 1)
