"""The bilinear sample's VJP into its map: CUDA kernel wrapper and plain version.

``texel_grad(uv, g, shape)`` is the gradient of an (h, w, c) map from the
cotangents ``g`` (..., c) of ``textures.sample_bilinear(map, uv)`` at the
(..., 2) UVs ``uv``, computed by ``csrc/texel_grad.cu`` on CUDA tensors:
each block sums its lanes' taps into its own copy of the map's gradient in
shared memory, and a second launch adds the copies in a fixed order, so the
result is the same from run to run on one card.  ``texel_grad_reference``
is the plain version (autograd's backward of the plain sample: four
``index_add_``).

``sample_learnt(tex, uv)`` is ``textures.sample_bilinear`` whose gradient
into ``tex`` comes from the kernel where ``texel_kernel_route`` says so; it
is the sampler of the fused route's composition
(``megakernel.compose_deferred``) alone.  ``textures.sample_bilinear``
itself, and every plain route built on it, stays autograd's.
``TEXEL_GRAD_LAUNCHES["shared"]`` counts the kernel's launches;
``megakernel.reset_launches`` zeroes it.  A failed build or launch, or a
tensor of another dtype, shape or device, raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from bpt_tpu_torch.kernels import build
from bpt_tpu_torch.textures import sample_bilinear
from bpt_tpu_torch.utils.profiling import span

KERNEL = "texel_grad"
#: Channels the kernel takes: a map of more takes the plain route.
MAX_CHANNELS = 4
WARP = 32  # threads of a block of the first pass (csrc/texel_grad.cu kWarp)
AHEAD = 4  # lanes a thread loads at once (kAhead): a block's span is WARP * AHEAD lanes
#: Launches of the texel VJP, zeroed by ``megakernel.reset_launches``.
TEXEL_GRAD_LAUNCHES = {"shared": 0}

_smem_limits: dict = {}  # device index -> the opt-in shared memory of a block, bytes
_capacities: dict = {}  # (device index, shared bytes) -> blocks the device holds at once


def shared_bytes(h: int, w: int, c: int) -> int:
    """The shared memory of a block for an (h, w, c) map: its copy of the
    map's gradient and the warp's staged cotangents, float32."""
    return 4 * (h * w * c + WARP * c)


def texel_kernel_route(tex: torch.Tensor, uv: torch.Tensor, limit: int) -> bool:
    """Whether ``sample_learnt(tex, uv)`` takes its gradient into ``tex``
    from the kernel: a float32 (h, w, c) CUDA map of at most
    ``MAX_CHANNELS`` channels that requires a gradient and whose block fits
    ``limit`` bytes of shared memory, float32 UVs that need no gradient,
    while autograd records.  Otherwise autograd differentiates the plain
    sample: on the CPU, under ``no_grad`` or ``inference_mode``, for a map
    over the limit (a 2048² map), and where the UVs require a gradient (it
    reaches them through fx and fy, which the kernel leaves out)."""
    return (tex.is_cuda and tex.requires_grad and not uv.requires_grad and torch.is_grad_enabled()
            and tex.dtype == uv.dtype == torch.float32 and len(tex.shape) == 3
            and tex.shape[-1] <= MAX_CHANNELS and shared_bytes(*tex.shape) <= limit)


def texel_grad_reference(uv: torch.Tensor, g: torch.Tensor, shape) -> torch.Tensor:
    """The plain version: autograd's gradient of the plain bilinear sample
    of an (h, w, c) map at ``uv`` with the cotangents ``g``."""
    with torch.enable_grad():
        tex = torch.zeros(shape, dtype=g.dtype, device=g.device, requires_grad=True)
        return torch.autograd.grad(sample_bilinear(tex, uv.detach()), tex, g)[0]


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bpt_texel_grad_smem_limit.argtypes = [p]
    lib.bpt_texel_grad_capacity.argtypes = [i, i, p]
    lib.bpt_texel_grad.argtypes = [p, p, ll, i, i, i, i, i, p, p, p]
    for fn in (lib.bpt_texel_grad_smem_limit, lib.bpt_texel_grad_capacity, lib.bpt_texel_grad):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def smem_limit(device: torch.device) -> int:
    """The CUDA ``device``'s opt-in shared memory of a block, bytes, queried
    once per device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _smem_limits:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _check(_library().bpt_texel_grad_smem_limit(ctypes.byref(out)), "the shared memory query")
        _smem_limits[index] = out.value
    return _smem_limits[index]


def _capacity(lib: ctypes.CDLL, index: int, smem: int) -> int:
    """The blocks of ``smem`` bytes the current device (``index``) holds at
    once, queried once per device and size."""
    if (index, smem) not in _capacities:
        out = ctypes.c_int(0)
        _check(lib.bpt_texel_grad_capacity(smem_limit(index), smem, ctypes.byref(out)), "the occupancy query")
        _capacities[index, smem] = out.value
    return _capacities[index, smem]


def texel_grad(uv: torch.Tensor, g: torch.Tensor, shape) -> torch.Tensor:
    """The (h, w, c) map's gradient from the cotangents ``g`` (..., c) of its
    bilinear samples at ``uv`` (..., 2): one launch of the kernel and one of
    its sum, on float32 CUDA tensors and a map whose block fits the card's
    shared memory (``texel_kernel_route``)."""
    h, w, c = (int(s) for s in shape)
    if uv.device != g.device:
        raise ValueError(f"uv is on {uv.device}, g on {g.device}")
    if uv.shape[-1] != 2 or g.shape != uv.shape[:-1] + (c,):
        raise ValueError(f"uv must be (..., 2) and g (..., {c}), got {tuple(uv.shape)} and {tuple(g.shape)}")
    if not uv.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {uv.device} (texel_grad_reference is the plain version)")
    for name, t in (("uv", uv), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    smem = shared_bytes(h, w, c)
    if not 1 <= c <= MAX_CHANNELS or h < 1 or w < 1 or smem > smem_limit(uv.device):
        raise ValueError(f"the kernel takes maps of 1 to {MAX_CHANNELS} channels whose gradient fits a block's "
                         f"shared memory, got {(h, w, c)}")
    uv_f, g_f = uv.reshape(-1, 2).contiguous(), g.reshape(-1, c).contiguous()
    n = uv_f.shape[0]
    lib = _library()
    with torch.cuda.device(uv.device), span("bpt.replay.texel_grad"):
        blocks = max(1, min(_capacity(lib, uv.device.index, smem), -(-n // (WARP * AHEAD))))
        partials = torch.empty(blocks * h * w * c, dtype=torch.float32, device=uv.device)
        out = torch.empty((h, w, c), dtype=torch.float32, device=uv.device)
        stream = torch.cuda.current_stream(uv.device).cuda_stream
        _check(lib.bpt_texel_grad(uv_f.data_ptr(), g_f.data_ptr(), n, h, w, c, smem, blocks, partials.data_ptr(),
                                  out.data_ptr(), stream), "texel_grad's launch")
    TEXEL_GRAD_LAUNCHES["shared"] += 1
    return out


class _TexelVJP(torch.autograd.Function):
    """``textures.sample_bilinear`` with its map's gradient from the kernel:
    the forward is the plain sample (the same operations and floats), the
    backward one ``texel_grad`` of the saved UVs (not itself
    differentiable)."""

    @staticmethod
    def forward(ctx, tex, uv):
        ctx.save_for_backward(uv)
        ctx.shape = tuple(tex.shape)
        return sample_bilinear(tex, uv)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (uv,) = ctx.saved_tensors
        return texel_grad(uv, g, ctx.shape), None


def sample_learnt(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """``textures.sample_bilinear(tex, uv)``, its gradient into ``tex`` from
    the kernel where ``texel_kernel_route`` says so, else from autograd."""
    if tex.is_cuda and texel_kernel_route(tex, uv, smem_limit(tex.device)):
        return _TexelVJP.apply(tex, uv)
    return sample_bilinear(tex, uv)
