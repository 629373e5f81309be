"""The wavefront closest-hit query: CUDA kernel wrapper, plain version, VJP.

Port of ``bpt_tpu.kernels.traverse``.  The JAX package has two Pallas
kernels for it, ``packet_closest_hit`` (K3, the tables resident in VMEM)
and ``hbm_closest_hit`` (K4, the triangle table streamed from HBM), both
over the TPU's clusterized packs.  On the card both are one kernel,
``csrc/closest_hit.cu``: one thread per ray walks the mesh's binary BVH
with the megakernel's walk, over the child-pair node records of its
``MeshTables`` (made once by ``Scene.to``).

``closest_hit(ro, rd, cull, active, mesh)`` takes (..., 3) object-space
rays with unnormalized directions and returns ``(t, tri, u, v)``: t =
INFINITY and tri = -1 on a miss, u and v the winner's barycentrics.  On
CUDA tensors it launches the kernel, on CPU tensors it runs the plain
version, ``closest_hit_reference`` (``accel.traverse.traverse_bvh``).  A
failed build or launch raises.  Its gradient is ``_ClosestHit``'s backward,
the port of ``_recompute``: t, u, v of the winning triangle recomputed from
ro, rd and its vertices in differentiable torch, in the walk's own
expression order; missed lanes get no gradient.  Unlike the JAX package,
whose packs get zero cotangents, vertex tensors that require a gradient
get one through the gathered vertices.
"""

from __future__ import annotations

import ctypes

import torch

from bpt_tpu_torch.accel.traverse import MAX_STACK_DEPTH, tri_t_uv, traverse_bvh
from bpt_tpu_torch.kernels import build
from bpt_tpu_torch.scenes.types import TriangleMesh, check_walk_tables, kernel_tables_of

KERNEL = "closest_hit"
#: Launches of the closest-hit kernel.
LAUNCHES = {"closest_hit": 0}


def reset_launches() -> None:
    """Set the launch count to 0."""
    LAUNCHES["closest_hit"] = 0


def closest_hit_reference(ro: torch.Tensor, rd: torch.Tensor, cull: bool, active, mesh: TriangleMesh):
    """The plain PyTorch version: the per-lane walk of ``traverse_bvh``."""
    return traverse_bvh(mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max, mesh.p0, mesh.p1, mesh.p2, ro,
                        rd, cull, MAX_STACK_DEPTH, active=active)


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    p = ctypes.c_void_p
    lib.bpt_closest_hit.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_int, p, p, p, p, p]
    lib.bpt_closest_hit.restype = ctypes.c_int
    return lib


def _launch(ro: torch.Tensor, rd: torch.Tensor, cull: bool, active, mesh: TriangleMesh):
    """Check and launch the kernel on the current stream: (t, tri, u, v)."""
    device = ro.device
    shape = ro.shape[:-1]
    tables = kernel_tables_of(mesh)
    for name, t in (("ro", ro), ("rd", rd), ("nodes", tables.nodes), ("tris", tables.tris)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    check_walk_tables(tables)
    if rd.shape != ro.shape or ro.shape[-1] != 3:
        raise ValueError(f"ro and rd must be (..., 3) of one shape, got {tuple(ro.shape)} and {tuple(rd.shape)}")
    n = ro.numel() // 3
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernel takes fewer than 2**31")
    ro_f, rd_f = ro.reshape(-1, 3).contiguous(), rd.reshape(-1, 3).contiguous()
    act = None
    if active is not None:
        if active.shape != shape or active.device != device:
            raise ValueError(f"active must be a {tuple(shape)} mask on {device}")
        act = active.reshape(-1).to(torch.bool).contiguous()
    t = torch.empty(n, dtype=torch.float32, device=device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty(n, dtype=torch.int64, device=device)
    if n:
        lib = _library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.bpt_closest_hit(ro_f.data_ptr(), rd_f.data_ptr(), 0 if act is None else act.data_ptr(),
                                      tables.nodes.data_ptr(), tables.tris.data_ptr(), n, int(cull), t.data_ptr(),
                                      tri.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"closest_hit_kernel launch failed: CUDA error {err}")
        LAUNCHES["closest_hit"] += 1
    return t.reshape(shape), tri.reshape(shape), u.reshape(shape), v.reshape(shape)


class _ClosestHit(torch.autograd.Function):
    """The closest hit with the gradient of ``_recompute``.

    Forward: the kernel on CUDA tensors, the plain walk (no autograd) on CPU
    tensors.  Backward: for each lane that hit, t, u and v recomputed from
    ro, rd and the winner's vertices ``p0..p2[tri]`` by ``tri_t_uv`` (the
    walk's own expressions, so the recomputed values are the forward's),
    differentiated by autograd; lanes that missed get zero cotangents, as in
    ``_pch_bwd``.  A tensor the walk read that requires no gradient gets
    none."""

    @staticmethod
    def forward(ctx, ro, rd, p0, p1, p2, cull, active, mesh):
        if ro.device.type == "cpu":
            t, tri, u, v = closest_hit_reference(ro, rd, cull, active, mesh)
        else:
            t, tri, u, v = _launch(ro, rd, cull, active, mesh)
        ctx.save_for_backward(ro, rd, p0, p1, p2, tri)
        ctx.mark_non_differentiable(tri)
        return t, tri, u, v

    @staticmethod
    def backward(ctx, g_t, g_tri, g_u, g_v):
        ro, rd, p0, p1, p2, tri = ctx.saved_tensors
        grads = recompute_vjp(ro, rd, (p0, p1, p2), tri, (g_t, g_u, g_v), ctx.needs_input_grad[:5])
        return grads + (None,) * 3


def recompute_vjp(ro, rd, vertices, tri, cotangents, needs=(True,) * 5):
    """The closest hit's VJP (the port of ``_recompute`` with ``_pch_bwd``'s
    masking): (g_ro, g_rd, g_p0, g_p1, g_p2), None where ``needs`` is False
    or no cotangent is given, from the winning triangles ``tri`` (-1: a
    miss, no gradient) and the cotangents of (t, u, v) (None: zero)."""
    pairs = [(i, g) for i, g in enumerate(cotangents) if g is not None]
    if not pairs or not any(needs):
        return (None,) * 5
    lanes = torch.nonzero(tri.reshape(-1) >= 0).squeeze(1)  # the lanes that hit: the others get nothing
    tid = tri.reshape(-1)[lanes]
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(need) for x, need in zip((ro, rd) + tuple(vertices), needs)]
        outs = tri_t_uv(leaves[2][tid], leaves[3][tid], leaves[4][tid], leaves[0].reshape(-1, 3)[lanes],
                        leaves[1].reshape(-1, 3)[lanes])
        wanted = [x for x, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad([outs[i] for i, _ in pairs], wanted,
                                         [g.reshape(-1)[lanes] for _, g in pairs], allow_unused=True))
    return tuple(next(grads) if need else None for need in needs)


def closest_hit(ro: torch.Tensor, rd: torch.Tensor, cull: bool, active, mesh: TriangleMesh):
    """Closest triangle hit of (..., 3) object-space rays (rd unnormalized)
    over ``mesh``: ``(t, tri, u, v)``, t = INFINITY and tri = -1 on a miss
    and off the ``active`` mask (None: every lane).  Differentiable in ro,
    rd and the vertices."""
    return _ClosestHit.apply(ro, rd, mesh.p0, mesh.p1, mesh.p2, bool(cull), active, mesh)
