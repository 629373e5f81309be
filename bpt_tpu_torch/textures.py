"""Texture sampling with REPEAT wrap, and tangent-space normal mapping.

Port of ``bpt_tpu.textures``: ``sample_bilinear``, ``sample_nearest`` and
``perturb_normal`` are the plain PyTorch versions of what the CUDA kernel
does per lane (``csrc/textures.cuh``), in the same operation order.  A map
is (H, W, C) float32 with v = 0 at row 0.  The reference's ``quad_pack``
(2x2 texel quads in one row, because a TPU gather costs the same per row
whatever its width) returns in the kernels' texel table: ``texel_quads``
packs each map's footprints as 16-byte slots, so that a GPU thread loads a
sample's four taps from one 64-byte record, and ``sample_table`` is that
table's plain sampler, bit-equal to ``sample_bilinear``.
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.core.vecmath import cross, dot


def _texel_coords(tex: torch.Tensor, uv: torch.Tensor):
    """The bilinear taps' integer rows and columns (int32, then the floored
    modulo of ``jnp.mod``: a UV below 0 or above 1 wraps) and the weights
    fx, fy."""
    return _coords(tex.shape[0], tex.shape[1], uv)


def _coords(h: int, w: int, uv: torch.Tensor):
    """``_texel_coords`` of an (h, w) map."""
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int32), h)
    y1i = torch.remainder(y0i + 1, h)
    return x0i.long(), x1i.long(), y0i.long(), y1i.long(), fx, fy


def gather_texels(tex: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """tex[rows, cols] for an (H, W, C) map, as one ``index_select`` of the
    flattened map: the same values, but its backward is an ``index_add_``,
    where the backward of advanced indexing sorts the indices and walks each
    run of duplicates serially (a million lanes sampling a 64x64 map took
    seconds per sample on the card)."""
    flat = tex.reshape(-1, tex.shape[-1])
    index = (rows * tex.shape[1] + cols).reshape(-1)
    return flat.index_select(0, index).reshape(rows.shape + (tex.shape[-1],))


def sample_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with REPEAT wrap on both axes: (H, W, C) map, (..., 2)
    UVs (any values) -> (..., C), combined as
    (c00 (1 - fx) + c01 fx) (1 - fy) + (c10 (1 - fx) + c11 fx) fy."""
    x0i, x1i, y0i, y1i, fx, fy = _texel_coords(tex, uv)
    c00 = gather_texels(tex, y0i, x0i)
    c01 = gather_texels(tex, y0i, x1i)
    c10 = gather_texels(tex, y1i, x0i)
    c11 = gather_texels(tex, y1i, x1i)
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def texel_quads(tex: torch.Tensor) -> torch.Tensor:
    """The kernels' texel table of one (H, W, 3) map (csrc/textures.cuh):
    the reference's ``quad_pack`` footprints as 16-byte slots, (H, W, 4, 4)
    float32 on the map's device.  Record [y, x] holds texels (y, x),
    (y, x + 1), (y + 1, x) and (y + 1, x + 1) with REPEAT wrap, each its
    three channels and a zero: the four taps of every sample whose first
    tap is (y, x).  The same floats as the map; no gradient flows through
    it."""
    with torch.no_grad():
        quads = torch.zeros(tex.shape[:2] + (4, 4), dtype=torch.float32, device=tex.device)
        down = torch.roll(tex, -1, 0)
        for k, t in enumerate((tex, torch.roll(tex, -1, 1), down, torch.roll(down, -1, 1))):
            quads[:, :, k, :3] = t
    return quads


def sample_table(quads: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """``sample_bilinear`` of a map read from its texel table (``texel_quads``),
    (..., 2) UVs -> (..., 3): one record gathered per sample, its taps
    combined in ``sample_bilinear``'s order, so the same floats come out.
    The plain version of the kernels' texel fetch, for the tests."""
    h, w = quads.shape[0], quads.shape[1]
    x0i, _, y0i, _, fx, fy = _coords(h, w, uv)
    rec = quads.reshape(h * w, 16).index_select(0, (y0i * w + x0i).reshape(-1)).reshape(y0i.shape + (4, 4))
    c00, c01, c10, c11 = (rec[..., k, :3] for k in range(4))
    return (c00 * (1 - fx) + c01 * fx) * (1 - fy) + (c10 * (1 - fx) + c11 * fx) * fy


def texels_read(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """For measurement: the (H, W) bool mask of the texels that
    ``sample_bilinear(tex, uv)`` reads for the (N, 2) UVs ``uv``."""
    x0i, x1i, y0i, y1i, _, _ = _texel_coords(tex, uv)
    read = torch.zeros(tex.shape[:2], dtype=torch.bool, device=tex.device)
    for y in (y0i, y1i):
        for x in (x0i, x1i):
            read[y, x] = True
    return read


def sample_nearest(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-texel sample with REPEAT wrap (texelFetch-style)."""
    h, w = tex.shape[0], tex.shape[1]
    xi = torch.remainder(torch.floor(uv[..., 0] * w).to(torch.int32), w)
    yi = torch.remainder(torch.floor(uv[..., 1] * h).to(torch.int32), h)
    return tex[yi.long(), xi.long()]


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / sqrt(max(|v|², 1e-20)), a true division as in the reference's
    perturbNormal."""
    return v / torch.sqrt(torch.clamp(dot(v, v), min=1e-20))[..., None]


def perturb_normal(n_obj: torch.Tensor, normal_map: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Tangent-space normal mapping of the (..., 3) object-space shading
    normal ``n_obj`` (the reference perturbs before the world transform).

    The tangent frame is the cross-trick ONB of the samplers: up = (0, 1, 0)
    where |n.y| < 0.9, else (1, 0, 0); S = unit(cross(up, n)), T = cross(n, S).
    The map's texel m = 2 * sample - 1, unit, gives unit(S m.x + T m.y + n m.z).
    The reference's normal_scale argument is left out: its one call site
    passes (1, 1)."""
    nl = _unit(n_obj)
    up_y = (torch.abs(nl[..., 1]) < 0.9)[..., None]
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=nl.dtype, device=nl.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=nl.dtype, device=nl.device)
    s = _unit(cross(torch.where(up_y, ey, ex), nl))
    t = cross(nl, s)
    map_n = _unit(sample_bilinear(normal_map, uv)[..., :3] * 2.0 - 1.0)
    out = s * map_n[..., 0:1] + t * map_n[..., 1:2] + nl * map_n[..., 2:3]
    return _unit(out)
