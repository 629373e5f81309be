# Frozen copy of bpt_tpu_torch/postprocess.py at commit 930457f (the benchmark's plain reference).
# Imports point into benchmark.reference; nothing of bpt_tpu_torch is imported.
"""screenOutput pass: edge-aware denoise → average → Reinhard → gamma.

Port of ``bpt_tpu.postprocess``.  Neighbour reads are edge-clamped shifts of
the (H, W, C) image; row 0 is the bottom, so +dy is +row.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The 5x5 "plus-then-diagonal" gated kernel: 8 groups of (gate offset,
# [child offsets]) in the shader's accumulation order; (dx, dy), +y = up.
_GROUPS_5X5 = (
    ((-1, 0), ((-2, 0), (-2, 1))),  # left
    ((1, 0), ((2, 0), (2, -1))),  # right
    ((0, 1), ((0, 2), (1, 2))),  # above
    ((0, -1), ((0, -2), (-1, -2))),  # below
    ((-1, 1), ((-2, 2), (-1, 2))),  # upper-left
    ((1, 1), ((2, 2), (2, 1))),  # upper-right
    ((-1, -1), ((-2, -1), (-2, -2))),  # lower-left
    ((1, -1), ((1, -2), (2, -2))),  # lower-right
)

_OFFSETS_3X3 = ((-1, 0), (1, 0), (0, 1), (0, -1), (-1, 1), (1, 1), (-1, -1), (1, -1))


def _pad_edge(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (H+4, W+4, C), edge-clamped."""
    chw = img.permute(2, 0, 1)[None]
    return F.pad(chw, (2, 2, 2, 2), mode="replicate")[0].permute(1, 2, 0)


def _shift(padded: torch.Tensor, dx: int, dy: int, h: int, w: int) -> torch.Tensor:
    """Value of the pixel at (x+dx, y+dy), edge-clamped, from ``_pad_edge``."""
    return padded[2 + dy: 2 + dy + h, 2 + dx: 2 + dx + w]


def denoise(accum: torch.Tensor) -> torch.Tensor:
    """Edge-aware blur of the (H, W, 4) accumulation buffer → (H, W, 3)."""
    h, w = accum.shape[0], accum.shape[1]
    padded = _pad_edge(accum)
    rgb = accum[..., :3]
    alpha = accum[..., 3:4]
    zero = torch.zeros_like(rgb)

    total = rgb
    count = torch.ones_like(alpha)
    for gate_off, children in _GROUPS_5X5:
        gate_px = _shift(padded, *gate_off, h, w)
        gate_ok = gate_px[..., 3:4] < 1.0
        total = total + torch.where(gate_ok, gate_px[..., :3], zero)
        count = count + gate_ok.to(alpha.dtype)
        for child_off in children:
            child_px = _shift(padded, *child_off, h, w)
            child_ok = gate_ok & (child_px[..., 3:4] < 1.0)
            total = total + torch.where(child_ok, child_px[..., :3], zero)
            count = count + child_ok.to(alpha.dtype)
    filtered = total / count

    total9 = rgb
    count9 = torch.ones_like(alpha)
    for off in _OFFSETS_3X3:
        px = _shift(padded, *off, h, w)
        ok = px[..., 3:4] < 1.0
        total9 = total9 + torch.where(ok, px[..., :3], zero)
        count9 = count9 + ok.to(alpha.dtype)
    filtered9 = 0.5 * (total9 / count9) + 0.5 * rgb

    is_edge = (alpha > 0.0) | (alpha == -1.0)
    return torch.where(is_edge, filtered9, filtered)


def reinhard(color: torch.Tensor, exposure) -> torch.Tensor:
    """Reinhard tonemap."""
    c = color * exposure
    return torch.clamp(c / (1.0 + c), 0.0, 1.0)


def screen_output(accum: torch.Tensor, one_over_sample_counter, tone_mapping_exposure=1.0,
                  apply_denoise: bool = True) -> torch.Tensor:
    """(H, W, 4) running-sum buffer → (H, W, 3) display rgb.

    Converged sharp pixels bypass the blur: alpha == 1.01 once 1/N < 0.005,
    and every pixel once 1/N < 0.0002.
    """
    inv_n = torch.as_tensor(one_over_sample_counter, dtype=accum.dtype, device=accum.device)
    rgb = accum[..., :3]
    alpha = accum[..., 3:4]
    if apply_denoise:
        filtered = denoise(accum)
        bypass = ((alpha == 1.01) & (inv_n < 0.005)) | (inv_n < 0.0002)
        filtered = torch.where(bypass, rgb, filtered)
    else:
        filtered = rgb
    averaged = filtered * inv_n
    toned = reinhard(averaged, tone_mapping_exposure)
    return torch.clamp(torch.pow(torch.clamp(toned, min=0.0), 0.4545), 0.0, 1.0)
