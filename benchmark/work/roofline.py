"""The roofline yardstick of the benchmark: the FP32 operations and bytes a
kernel needs for the work that a plain run counted, and the least time the
card could take for them.

Frozen copy of ``chip_smoke.py`` at commit 930457f (lines 304-349: the
published peaks and the per-thread operation counts; 398-488: ``bound``,
``mesh_records_read``, ``kernel_work``, ``texels_read``; 1561-1583:
``staged_work``), so that a later change to the
port or to its smoke script moves no bound.  ``grad_planes_work`` is the
grads mode's share that ``chip_smoke.py`` adds inline (lines 1942-1945 and
2881-2885): one add per counted path-replay term and each plane written
once.  The lane counts come from the benchmark's plain reference
(``benchmark.reference``), never from the port.
"""

from __future__ import annotations

import torch

SIZE = 1024  # the film side the counts default to (chip_smoke.py's SIZE)

# Published peaks of one H100 SXM at a 700 W limit (NVIDIA's data sheet):
# float32 outside the tensor cores, and HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations per thread, counted from csrc/megakernel.cu and its
# headers: +, -, *, /, sqrt and each transcendental count one; compares,
# selects, min/max/abs and the integer RNG hash are not counted.
RAYGEN_FLOP = 80  # tent AA, film mapping, thin lens, two normalizations
SPHERE_FLOP = 68  # per sphere per live bounce: transform, quadratic, roots, normal
QUAD_FLOP = 104  # per quad per live bounce: two Moller-Trumbore triangles of 52
# The parallelogram test (csrc/path.cuh parallelogram_t), per quad per live
# bounce when the scene takes it: denom 5, ron 5, tt 3 (c0 - ron, the guarded
# inverse, the product), the hit point 9, aa 6, bb 6.  Its per-quad algebra
# (e1 3, e3 3, ng 9, d1 9, d3 9, den1 5, den3 5, k1 1, k3 1, c0 5) is made
# once per quad geometry in torch: counted once per launch.
PARALLELOGRAM_FLOP = 34
QUAD_ALGEBRA_FLOP = 50
HIT_FLOP = 24  # per hit: normal, facing test, hit point (21) + the cheapest branch (3)
# Per live bounce, the 12 shapes of csrc/quadrics.cuh, each with its 33-FLOP
# transform and its cheapest exit: sphere 68, cylinder 67, cone 96,
# paraboloid 72, hyperboloid 94, capsule 127, ring 79, box 48, pyramid 131,
# disk 44, rectangle 41, torus bound 81 (the hit's normal is not counted).
QUADRIC_SET_FLOP = 948
TORUS_STEP_FLOP = 18  # one SDF march step: the point, map_torus, t += d
SKY_FLOP = 132  # one Preetham evaluation on a miss (csrc/sky.cuh sky_color)
# The mesh walk (csrc/bvh.cuh), per live lane of a bounce: the ray to object
# space (18 + 15), its inverse direction (3) and the root slab test (12);
# per inner node visited, the two children's slab tests (2 x 12); per
# triangle test, Moller-Trumbore (52).  The winner's normal is not counted.
MESH_RAY_FLOP = 48
NODE_VISIT_FLOP = 24
TRI_TEST_FLOP = 52
HDRI_FLOP = 45  # one equirect lookup on a miss (csrc/hdri.cuh hdr_color)
# A textured mesh (csrc/textures.cuh): a bilinear sample (the coordinates
# 10, three channels of 9); 3 more for the decode of an albedo, emissive or
# metallic-roughness sample; 75 more for the normal map's frame and
# normalisations; the winner's UV (12) per PBR hit; the roughness lobe (70:
# the exponent, the ONB, the lobe and its mix) per lobe draw.
TEX_SAMPLE_FLOP = 37
TEX_DECODE_FLOP = 3
NORMAL_MAP_FLOP = 75
MESH_UV_FLOP = 12
LOBE_FLOP = 70
CH_RAY_FLOP = 15  # the closest-hit kernel, per live lane: the inverse direction (3) and the root slab test (12)
CH_RAY_BYTES = 24  # the closest-hit kernel reads a live lane's ro and rd
CH_RESULT_BYTES = 20  # and writes every lane's t, u, v and int64 triangle id


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = flop / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def mesh_records_read(lane_counts) -> list[int]:
    """The distinct node, triangle and vertex-normal records of the mesh
    that a frame's walks read: the union over the bounces of the plain
    run's masks."""
    return [int(torch.stack([c.mesh_reads[i] for c in lane_counts]).any(0).sum().item()) for i in range(3)]


def kernel_work(lane_counts, n_quads: int, n_spheres: int, pixels: int, n_quadrics: int = 0,
                sky: bool = False, mesh: bool = False, hdri=None, env_nee: bool = False,
                textured: bool = False, deferred: bool = False, as_fans: bool = False) -> tuple[float, float]:
    """(FP32 operations, bytes) the kernel needs for one frame whose
    plain run reported ``lane_counts`` (per bounce: live, hit and missed
    lanes, the torus march's steps, the mesh walk's inner-node visits and
    triangle tests on live lanes and the mesh records it read).  Each input
    byte the kernel reads is counted once: the blue-noise table, the packed
    scene, the parameter pack; of the mesh (``mesh``), 32 bytes for each
    node box (the root's in the header of the child-pair records, a child's
    in its parent's record: the plain walk's node mask marks the root and
    the children of every visited inner node), the 48-byte triangle and
    48-byte vertex-normal records the frame's walks read, each distinct box
    or record once (the plain walk's masks, their union over the bounces);
    the HDR map of the environment ``hdri`` whole, and
    its CDF tables only under env NEE (``env_nee``).  Each of the 11 output
    planes is written once.  Sphere normals of closer hits, quadric and
    mesh normals, NEE draws and all but the cheapest shading branch are left
    out, so the operation count is a lower bound.  With ``textured``, the
    texel samples an output reads (per map: ``LaneCounts.texel_samples``,
    no normal-map sample on a shadow ray, no emissive sample off a specular
    path), their decode and the normal map's frame, the
    UV of each PBR hit and the lobe draws add their operations, and each
    distinct texel the samples read (12 bytes, RGB; 8 of the
    metallic-roughness map, whose G and B are all the decode reads) and the
    24-byte UV record of each winning triangle their bytes.  With
    ``deferred`` (the grads mode, whose own planes the caller adds) the
    kernel leaves the environment's radiance on a miss under ``hdri`` and
    the albedo's samples to the composition outside it: neither map is read
    and neither lookup is counted; the CDF tables of env NEE still are.

    A quad test of a live lane counts the parallelogram test's operations
    where the plain run made it (``parallelogram_tests``), plus the per-quad
    algebra once, and the two fans' elsewhere; ``as_fans`` counts every
    quad test as the two fans (the bound before the kernel took the
    parallelogram test)."""
    live = sum(int(c.live) for c in lane_counts)
    hits = sum(int(c.hits) for c in lane_counts)
    misses = sum(int(c.misses) for c in lane_counts)
    par = 0 if as_fans else sum(int(c.parallelogram_tests) for c in lane_counts)
    quad_flop = ((live * n_quads - par) * QUAD_FLOP + par * PARALLELOGRAM_FLOP
                 + (n_quads * QUAD_ALGEBRA_FLOP if par else 0))
    flop = (pixels * RAYGEN_FLOP + live * n_spheres * SPHERE_FLOP + quad_flop + hits * HIT_FLOP
            + (live * QUADRIC_SET_FLOP if n_quadrics else 0)
            + sum(int(c.torus_steps) for c in lane_counts) * TORUS_STEP_FLOP
            + (misses * SKY_FLOP if sky else 0) + (misses * HDRI_FLOP if hdri is not None and not deferred else 0))
    nbytes = (256 * 256 * 4 * 4 + 4 * (16 + 24 + 32 * n_quads + 24 * n_spheres + 20 * n_quadrics)
              + 11 * 4 * pixels)
    if mesh:
        flop += (live * MESH_RAY_FLOP + sum(int(c.node_visits) for c in lane_counts) * NODE_VISIT_FLOP
                 + sum(int(c.tri_tests) for c in lane_counts) * TRI_TEST_FLOP)
        nodes, tris, normals = mesh_records_read(lane_counts)
        nbytes += 4 * 17 + 32 * nodes + 48 * tris + 48 * normals
    if hdri is not None:
        tables = (() if deferred else (hdri.hdr_image,)) + (tuple(hdri.env_cdf) if env_nee else ())
        nbytes += 4 * sum(t.numel() for t in tables)
    if textured:
        albedo, normal, metal_rough, emissive = (int(x) for x in sum(c.texel_samples for c in lane_counts))
        sampled = 0 if deferred else albedo  # the albedo samples the kernel makes itself
        flop += ((sampled + normal + metal_rough + emissive) * TEX_SAMPLE_FLOP
                 + (sampled + metal_rough + emissive) * TEX_DECODE_FLOP + normal * NORMAL_MAP_FLOP
                 + albedo * MESH_UV_FLOP + sum(int(c.lobe_draws) for c in lane_counts) * LOBE_FLOP)
        albedo_t, normal_t, metal_rough_t, emissive_t = texels_read(lane_counts)
        nbytes += (12 * ((0 if deferred else albedo_t) + normal_t + emissive_t) + 8 * metal_rough_t
                   + 24 * mesh_records_read(lane_counts)[2])
    return flop, nbytes


def texels_read(lane_counts) -> list[int]:
    """The distinct texels of each map (albedo, normal, metallic-roughness,
    emissive) that a frame's samples read: the union over the bounces of the
    plain run's masks (0 for a map the mesh lacks)."""
    out = []
    for i in range(4):
        masks = [c.texel_reads[i] for c in lane_counts if c.texel_reads is not None and c.texel_reads[i] is not None]
        out.append(int(torch.stack(masks).any(0).sum().item()) if masks else 0)
    return out


STATE_ROW_BYTES = 56  # the words of a live lane's staged state row that carry state (csrc/staged.cu: 14 of 16)
PERM_BYTES = 4  # a lane's permutation index: a pool is under 2^31 lanes (torch.sort gives int64)


def staged_work(lane_counts, frames: int, lanes: int, scale: int = 1, pixels: int = SIZE * SIZE,
                **kw) -> tuple[float, float]:
    """(FP32 operations, bytes) of a pool of ``frames`` frames of ``pixels``
    (SIZE² unless told) whose
    plain run reported ``lane_counts`` (per bounce, over the pool): K1's
    work for those frames (``kernel_work``: each input read once, the 11
    planes of every frame written once), plus, at each boundary between
    phases, the 56 bytes of state of each live lane written and read again
    and a 4-byte permutation index of every lane: the least the function
    must move (the kernel moves the row's 2 pad words and an int64 index
    too).  With ``scale`` > 1 the counts are those of 1 frame of the
    ``frames``: operations and live lanes are scaled by it, and the output
    planes of the other frames added."""
    flop, nbytes = kernel_work(lane_counts, pixels=pixels * frames // scale, **kw)
    flop *= scale
    nbytes += (scale - 1) * 11 * 4 * pixels
    boundaries = lane_counts[1:]
    nbytes += sum(2 * STATE_ROW_BYTES * scale * int(c.live) + PERM_BYTES * lanes for c in boundaries)
    return flop, nbytes


def grad_planes_work(sg: torch.Tensor, n_obj: int, n_deferred: int, lanes: int) -> tuple[float, float]:
    """The grads mode's path-replay planes beyond ``kernel_work``: one add
    per counted term of the first ``n_obj`` planes, two per refraction term
    of the others, and each of the ``sg.shape[0] + n_deferred`` planes of
    ``lanes`` lanes written once (4 bytes a lane)."""
    flop = sg[:n_obj].sum().item() + 2 * (sg[n_obj:] > 0).sum().item()
    return float(flop), 4.0 * lanes * (sg.shape[0] + n_deferred)
