# Frozen copy of bpt_tpu_torch/env.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""HDRI equirect environment: lookup, sun estimate, importance-sampling CDF.

Port of ``bpt_tpu.env``.  ``get_hdr_color`` and ``sample_env_cdf`` are the
plain PyTorch versions of what the CUDA kernel does per lane
(``csrc/hdri.cuh``), in the same operation order; ``sun_direction_from_hdr``
and the CDF tables are built on the host (numpy, float64), as in the
reference, and the tables then live on the caller's device as float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.textures import gather_texels

ONE_OVER_TWO_PI = 0.15915494309
ONE_OVER_PI = 0.31830988618379067


def get_hdr_color(hdr_image: torch.Tensor, ray_dir: torch.Tensor, exposure) -> torch.Tensor:
    """Bilinear equirect lookup, u = atan2(x, z) / 2pi + 0.5,
    v = acos(-y) / pi, repeat in x and clamp in y, scaled by the exposure."""
    h, w = hdr_image.shape[0], hdr_image.shape[1]
    u = torch.atan2(ray_dir[..., 0], ray_dir[..., 2]) * ONE_OVER_TWO_PI + 0.5
    v = torch.acos(torch.clamp(-ray_dir[..., 1], -1.0, 1.0)) * ONE_OVER_PI
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int64), w)  # floored, as jnp.mod: x0 = -1 wraps to w - 1
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    c00 = gather_texels(hdr_image, y0i, x0i)  # index_select: a cheap backward into the map
    c01 = gather_texels(hdr_image, y0i, x1i)
    c10 = gather_texels(hdr_image, y1i, x0i)
    c11 = gather_texels(hdr_image, y1i, x1i)
    color = (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy
    return color * exposure


def sun_direction_from_hdr(hdr_image) -> np.ndarray:
    """The brightest (r+g+b) texel's direction, pointing exactly at it under
    ``get_hdr_color``'s mapping (host, numpy): (3,) float32, unit."""
    img = np.asarray(hdr_image)
    h, w = img.shape[0], img.shape[1]
    lum = img[..., :3].sum(axis=-1)
    idx = int(np.argmax(lum))
    ty, tx = divmod(idx, w)
    u = (tx + 0.5) / w
    v = (ty + 0.5) / h
    theta = v * np.pi
    phi = (u - 0.5) * 2.0 * np.pi
    d = np.array([np.sin(theta) * np.sin(phi), -np.cos(theta), np.sin(theta) * np.cos(phi)], np.float32)
    return d / np.linalg.norm(d)


class EnvCDF(NamedTuple):
    """Row and column luminance CDFs for equirect importance sampling."""

    row_cdf: torch.Tensor  # (H,)
    col_cdf: torch.Tensor  # (H, W)
    pdf: torch.Tensor  # (H, W) solid-angle pdf


def build_env_cdf(hdr_image, device=None) -> EnvCDF:
    """Luminance x sin(theta) marginal and conditional CDFs, computed on the
    host in float64 and stored as float32 tensors on ``device``."""
    img = np.asarray(hdr_image.cpu() if isinstance(hdr_image, torch.Tensor) else hdr_image, np.float64)
    h, w = img.shape[0], img.shape[1]
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    sin_theta = np.sin((np.arange(h) + 0.5) / h * np.pi)[:, None]
    weight = lum * sin_theta + 1e-12
    row_sum = weight.sum(axis=1)
    row_cdf = np.cumsum(row_sum) / row_sum.sum()
    col_cdf = np.cumsum(weight, axis=1) / weight.sum(axis=1, keepdims=True)
    p_img = weight / weight.sum()
    pdf = p_img * (h * w) / (2.0 * np.pi * np.pi * np.maximum(sin_theta, 1e-9))
    return EnvCDF(*(torch.as_tensor(a.astype(np.float32), device=device) for a in (row_cdf, col_cdf, pdf)))


def env_search_steps(width: int) -> int:
    """The column search's step count, ceil(log2 W) (at least 1)."""
    return max(1, int(np.ceil(np.log2(max(width, 2)))))


def env_cdf_index(cdf: EnvCDF, u1: torch.Tensor, u2: torch.Tensor):
    """The texel (row, col) that ``sample_env_cdf`` draws for (u1, u2): the
    row is the lower bound of u1 in ``row_cdf``; the column the result of
    ``env_search_steps(W)`` halving steps towards the lower bound of u2 in
    ``col_cdf[row]``, by single-texel gathers (``col_cdf[row]`` is never
    materialised: at 1024² lanes against a 2048-wide map it would take
    gigabytes)."""
    h = cdf.row_cdf.shape[0]
    w = cdf.col_cdf.shape[1]
    row = torch.clamp(torch.searchsorted(cdf.row_cdf, u1.contiguous()), 0, h - 1)
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w)
    flat = cdf.col_cdf.reshape(-1)
    for _ in range(env_search_steps(w)):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        v = flat[row * w + torch.clamp(mid, 0, w - 1)]
        go_hi = v < u2  # the first index with cdf >= u2
        lo = torch.where(go_hi, mid + 1, lo)
        hi = torch.where(go_hi, hi, mid)
    return row, torch.clamp(lo, 0, w - 1)


def sample_env_cdf(cdf: EnvCDF, u1: torch.Tensor, u2: torch.Tensor):
    """Inverse-CDF sample: (u1, u2) in [0, 1)^2 -> (direction (..., 3), pdf),
    the direction in ``get_hdr_color``'s equirect convention, through the
    centre of the texel ``env_cdf_index`` picks."""
    h = cdf.row_cdf.shape[0]
    w = cdf.col_cdf.shape[1]
    row, col = env_cdf_index(cdf, u1, u2)
    # divide by device tensors: on CUDA, PyTorch divides by a host scalar through its reciprocal
    f32 = dict(dtype=torch.float32, device=u1.device)
    v = (row.to(torch.float32) + 0.5) / torch.tensor(float(h), **f32)
    u = (col.to(torch.float32) + 0.5) / torch.tensor(float(w), **f32)
    theta = v * math.pi
    phi = (u - 0.5) * 2.0 * math.pi
    sin_t = torch.sin(theta)
    direction = torch.stack([sin_t * torch.sin(phi), -torch.cos(theta), sin_t * torch.cos(phi)], dim=-1)
    return direction, cdf.pdf.reshape(-1)[row * w + col]
