"""Row-tile SPMD rendering over ``torch.distributed`` (port of
``bpt_tpu.parallel.sharding``).

Each rank of a 1-D ``("tiles",)`` device mesh owns one device and the
contiguous rows its place on the mesh gives it: rank i of n traces rows
[i·H/n, (i+1)·H/n).  The scene and camera are replicated, and the RNG, the
blue noise and the rays are keyed by absolute pixel coordinates, so an
n-way split equals the single-process render bit for bit.

Communication, all of it:
  * none while tracing: each rank traces, detects edges and accumulates its
    own rows (the 2x2 edge quads never straddle tiles of even row count);
  * the gradient of a replicated scene parameter is summed over the ranks:
    ``replicate`` puts an all-reduce in the parameter's backward, where
    JAX's AD puts a ``psum`` for a replicated ``shard_map`` input, and
    ``sum_over_tiles`` sums a loss's per-rank partial sums (its backward is
    the identity: each rank differentiates its own rows);
  * the denoiser's 2-row halos: ``sharded_screen_output`` gathers each
    tile's two boundary rows from its neighbours.

The kernel route is the staged pool at absolute rows:
``kernels.megakernel.trace_frames_fused(..., height=tile_rows,
full_height=H, row_offset=r0)`` (K2 and its key kernel on CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_flatten, tree_unflatten

from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.integrator.config import IntegratorConfig
from bpt_tpu_torch.integrator.frame import render_frame, trace_image
from bpt_tpu_torch.postprocess import screen_output
from bpt_tpu_torch.scenes.types import Scene


def make_mesh(device_type: str | None = None, axis: str = "tiles") -> DeviceMesh:
    """1-D mesh over every rank of the default process group, in rank order;
    ``device_type`` defaults to "cuda" under NCCL and "cpu" otherwise."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis,))


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def tile_rows(height: int, mesh: DeviceMesh, axis: str = "tiles") -> tuple[int, int]:
    """(rows per tile, this rank's first row) of a ``height``-row film split
    over the mesh's ``axis``.  The tiles must have an even row count: the
    edge detector's 2x2 quads must not straddle them."""
    n = _axis_size(mesh, axis)
    rows = height // n
    if rows * n != height or rows % 2:
        raise ValueError(f"height {height} must split into {n} even-row tiles")
    return rows, mesh.get_local_rank(axis) * rows


class _Replicate(torch.autograd.Function):
    """Identity forward; the backward sums each gradient over the group's
    ranks (one all-reduce of the gradients laid end to end)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.shapes = [t.shape for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        return (None,) + tuple(part.reshape(shape)
                               for part, shape in zip(flat.split([s.numel() for s in ctx.shapes]), ctx.shapes))


def replicate(tree, mesh: DeviceMesh, axis: str = "tiles"):
    """``tree`` (a Scene, a Camera, any nest of NamedTuples, tuples, lists,
    dicts and tensors) with every tensor that requires a gradient passed through one
    ``_Replicate``: the values are the same, and each of their gradients is
    summed over the mesh's ranks, as JAX's AD sums the cotangent of a
    replicated ``shard_map`` input.  Every rank must then run the backward,
    and reach these tensors in it."""
    leaves, spec = tree_flatten(tree)
    grads = list({id(t): t for t in leaves if isinstance(t, torch.Tensor) and t.requires_grad}.values())
    if not grads or not torch.is_grad_enabled():
        return tree
    swap = {id(t): o for t, o in zip(grads, _Replicate.apply(mesh.get_group(axis), *grads))}
    return tree_unflatten([swap.get(id(t), t) for t in leaves], spec)


class _SumOverTiles(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, group, tensor):
        out = tensor.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def sum_over_tiles(partial: torch.Tensor, mesh: DeviceMesh, axis: str = "tiles") -> torch.Tensor:
    """The sum over ranks of each rank's ``partial`` (a loss's sum over its
    own rows), the same on every rank.  Its backward hands each rank's seed
    to its own rows unchanged; the sum over ranks happens in ``replicate``.
    (``torch.distributed.nn.functional.all_reduce`` all-reduces the seeds
    instead, which scales the gradient by the rank count and still leaves
    out the other ranks' rows.)"""
    return _SumOverTiles.apply(mesh.get_group(axis), partial)


def sharded_trace(scene: Scene, camera: Camera, cfg: IntegratorConfig, height: int, width: int, frame_counter,
                  rand_vec2, blue_noise: torch.Tensor, mesh: DeviceMesh, axis: str = "tiles"):
    """One 1-spp frame of a ``height`` x ``width`` film: this rank's rows of
    ``trace_image`` (the wavefront; the closest-hit kernel walks a mesh on
    CUDA tensors), on the device of ``blue_noise``."""
    rows, row0 = tile_rows(height, mesh, axis)
    scene, camera = replicate((scene, camera), mesh, axis)
    return trace_image(scene, camera, cfg, width, height, frame_counter, rand_vec2, blue_noise,
                       tile_rows=rows, row_offset=row0)


def sharded_render_frame(scene: Scene, camera: Camera, cfg: IntegratorConfig, previous: torch.Tensor,
                         frame_counter, camera_is_moving: bool, rand_vec2, blue_noise: torch.Tensor,
                         mesh: DeviceMesh, axis: str = "tiles") -> torch.Tensor:
    """One progressive step of this rank's rows: ``previous`` is its tile
    (rows, W, 4) of the film's accumulation buffer, the film has rows × n
    rows, and the result is the tile of ``render_frame``'s.  Trace, edge
    detection and the accumulation protocol run on the tile alone."""
    rows = previous.shape[0]
    height = rows * _axis_size(mesh, axis)
    _, row0 = tile_rows(height, mesh, axis)
    scene, camera = replicate((scene, camera), mesh, axis)
    return render_frame(scene, camera, cfg, previous, frame_counter, camera_is_moving, rand_vec2, blue_noise,
                        full_height=height, row_offset=row0)


def sharded_screen_output(accum: torch.Tensor, one_over_sample_counter, mesh: DeviceMesh,
                          tone_mapping_exposure=1.0, apply_denoise: bool = True, axis: str = "tiles") -> torch.Tensor:
    """``screen_output`` of this rank's tile (rows, W, 4), equal to the same
    rows of the whole film's.  The denoiser's 5x5 stencil reads two rows
    past each side of the tile: they are gathered from the neighbouring
    ranks (every rank's first and last two rows, one all-gather), and only
    the film's own bottom and top rows are clamped."""
    if not apply_denoise:
        return screen_output(accum, one_over_sample_counter, tone_mapping_exposure, False)
    if accum.shape[0] < 2:
        raise ValueError("a tile needs at least 2 rows for the denoiser's halo")
    group = mesh.get_group(axis)
    n = _axis_size(mesh, axis)
    i = mesh.get_local_rank(axis)
    edges = torch.cat([accum[:2], accum[-2:]]).contiguous()
    gathered = [torch.empty_like(edges) for _ in range(n)]
    dist.all_gather(gathered, edges, group=group)
    below = gathered[i - 1][2:] if i > 0 else accum[:1].expand(2, -1, -1)
    above = gathered[i + 1][:2] if i < n - 1 else accum[-1:].expand(2, -1, -1)
    padded = torch.cat([below, accum, above])
    return screen_output(padded, one_over_sample_counter, tone_mapping_exposure, True)[2:-2]
