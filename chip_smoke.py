"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device       — a CUDA device must exist; prints its name and power limit
                  (nvidia-smi) and the torch, CUDA and nvcc versions.
2. build        — builds the kernels from bpt_tpu_torch/csrc with nvcc, one
                  process per source, all at once (the megakernel, the
                  staged kernel, the sort key, the closest-hit kernel, the
                  texel VJP and loop_cost).
3. parity       — the forward kernel against its plain PyTorch version at
                  1024², 4 bounces, frame 2, for both right-sphere materials
                  (the parallelogram quad test, as the Cornell box decides);
                  the two triangle fans asked for (fast_quads=False) and a
                  sheared quad (decided: the fans), forward and grads mode.
4. main         — the serving path: ProgressiveRenderer (on the card by
                  default) renders the Cornell box at 1024², 8 spp; checks
                  launches, range, light placement and the motion reset.
5. timing       — CUDA-event times per frame of the forward kernel and of
                  its plain version at 1024², 4 bounces; its bound, with the
                  parallelogram test counted (every live lane's quad tests
                  must have taken it), and the bound counted as the two
                  fans.
6. grad-parity  — the grads-mode kernel against its plain version, and its
                  11 planes against the forward kernel's, bit for bit, at
                  1024² (METAL and TRANSPARENT right sphere, tint off; and
                  TRANSPARENT with tint on).
7. grad         — at 256², the path-replay gradient of mean(color·[1,2,3])
                  for the light, wall 2 and the glass sphere against
                  autograd through the plain trace_image (rtol 1e-4) and
                  central differences of the kernel's forward (rtol 2e-2).
8. train        — the training path: diff.inverse.optimize recovers the
                  light emission (1024², 4 bounces, 30 Adam steps).
9. grad-timing  — bench.py's default cell (1024², 4 bounces, 8 frames,
                  fwd+bwd w.r.t. the light color): its device operations
                  and host synchronizations, no more than before the
                  parallelogram test (PARENT_STEP_*); ms per step and rays/s,
                  forward-only step, each kernel's device time
                  (torch.profiler), the backward's torch part, and the
                  plain route at 256².
10. parity-quadric / parity-sky — the quadric configuration (the demo
                  scene, and shape_k 0.35 all TRANSPARENT) and the sky
                  configuration (METAL and TRANSPARENT right sphere) of the
                  forward kernel against their plain versions at 1024², 4
                  bounces, frame 2, bit for bit; the grads mode on the first
                  scene of each: planes equal to the plain version's and its
                  11 planes to the forward kernel's.
11. main-quadric / main-sky — the serving path of each family:
                  ProgressiveRenderer (on the card by default) renders 8 spp
                  at 1024²: 8 launches of that configuration, a finite
                  display in [0, 1]; the motion reset; all 12 quadric ids
                  among the first hits of a frame from a raised camera (the
                  demo camera's view hides the rectangle); sky pixels
                  flagged 1.01.
12. train-quadric / train-sky — the training path of each family:
                  diff.inverse.optimize (the grads kernel's path-replay VJP)
                  fits the shapes' grey level / the left sphere's color at
                  1024², 4 bounces, 10 Adam steps; the loss must fall.
13. timing-quadric / timing-sky — per configuration and mode: CUDA-event
                  time per frame through the wrapper, device time
                  (torch.profiler), the plain version's time, the bound
                  and the bound counted as the two fans;
                  the progressive frame time and Mrays/s.
14. grad-quadric — at 256², the path-replay gradient of mean(color·[1,2,3])
                  for quadric 11's color and the light against autograd
                  through the plain trace_image (rtol 1e-4) and central
                  differences of the kernel's forward (rtol 2e-2).
15. parity-mesh / parity-hdri — the mesh walk and the HDRI configurations
                  of the forward kernel against their plain versions at
                  1024², 4 bounces, frame 2, bit for bit: bench.py's
                  capacity scene (the 524,288-triangle heightfield, DIFFUSE,
                  the glTF camera), the same from a raised camera where the
                  mesh takes most first hits, the triangle blob METAL and
                  TRANSPARENT; the HDRI demo (the heightfield under
                  synthetic_hdr()) with sun NEE and with env NEE, and with
                  sun NEE under a map whose sun is above the horizon (its
                  shadow rays must reach the sky).
16. main-mesh / main-hdri — ProgressiveRenderer renders 8 spp of each at
                  1024²: 8 launches of that configuration, a finite display.
17. timing-mesh / timing-hdri — device time (torch.profiler), time through
                  the wrapper (CUDA events), the plain version's time, the
                  bound and its share, peak device memory.
18. refusals    — differentiable=True runs on mesh, HDRI and textured
                  scenes (a quad color, hdr_exposure, the albedo map get
                  gradients), with and without reorder=True; a mesh
                  transform, vertices or normal map that requires a
                  gradient raise NotImplementedError, metal_roughness_lobe
                  without a textured mesh, a staged pool past 2^31 lanes and
                  one on a device that is neither CPU nor CUDA ValueError.
19. parity-textured — the textured configuration against its plain version
                  at 1024², 4 bounces, frame 2, bit for bit, on a stand-in at
                  the reference's capacity (the 524,288-triangle heightfield
                  with planar UVs tiled 4x and offset past 0 and 1, and four
                  2048² maps made from a seed: a smooth albedo, a bump map, a
                  metallic-roughness map whose class changes inside
                  triangles, an emissive map with a few percent of its
                  texels lit), from the raised camera: the glTF demo's
                  configuration (quad NEE, the metal roughness lobe), the
                  HDRI demo's with sun NEE (the sun above the horizon) and
                  with env NEE, the lobe on.  The plain runs' lane counts
                  must show every PBR class, emissive terminations, texel
                  samples of all four maps and lobe draws with a roughness
                  above 0; the same under the sky with sun NEE.  Then the
                  stand-in with its normal map alone (no albedo: the mesh's
                  own material, TRANSPARENT), bit for bit, sampling the
                  normal map only.  The texel tables' build time and memory
                  (forward: every map; grads: no albedo); then at 256²,
                  forward and grads bit for bit, the stand-in with maps of
                  three sizes (the albedo and metallic-roughness maps 2048²,
                  the normal map 1024², the emissive map 512x1024), and
                  with its albedo halved in place and its normal map
                  replaced between two launches (repacked: the second
                  launch differs from the first).
20. main-textured — ProgressiveRenderer renders 8 spp of each at 1024²: 8
                  launches of the textured configuration, a finite display.
21. timing-textured — device time (torch.profiler), time through the
                  wrapper (CUDA events), the plain version's time, the bound
                  (the texel samples' operations and the distinct texels and
                  UV records read added) and its share, peak device memory.
22. parity-camera — the Cornell kernel with a thin lens (aperture 1, focus
                  100) and with camera_is_moving, bit for bit at 1024².
22b. inference-mode — K1 under torch.inference_mode on the capacity mesh
                  and on the textured stand-in, scenes moved to the card
                  inside it (inference tensors: Scene.to makes no tables
                  for them, each launch makes its own), bit-equal to the frames of the same scenes
                  made outside it; CUDA-event times of one mesh_tables
                  build, one texel-table build and a K1 launch with
                  resident tables, under no_grad and under inference_mode.
23. parity-closest-hit — the closest-hit kernel against the plain walk, bit
                  for bit in t, tri, u and v, at 1024²: the capacity mesh's
                  primary rays from the glTF and the raised camera, bounce
                  2's rays of a plain wavefront pass with its lane mask, the
                  blob METAL and TRANSPARENT (cull off), the textured
                  stand-in, the 64-triangle blob with every triangle twice
                  (most hits tie: the plain walk's read masks must show both
                  copies tested), a mesh of one triangle (the root a leaf),
                  a 1021x997 image and bounce 2's rays as a flat
                  (1000003, 3) set with its mask (lane counts that fill no
                  whole number of the kernel's 128-lane spans); its
                  recompute VJP on the card against the same
                  backward on CPU copies (rtol 1e-5).
24. wavefront-mesh — trace_image at 1024², 4 bounces, on the capacity scene
                  and the textured stand-in: the kernel walk against the
                  plain walk bit for bit, one closest-hit launch per bounce.
25. grad-parity-mesh — the grads mode of the mesh, HDRI sun and env (the sun
                  above the horizon), sky-with-a-mesh and textured (glTF
                  quad NEE with the lobe, HDRI sun, HDRI env) configurations
                  against its plain version on every plane, bit for bit;
                  the color composed from the deferred planes against the
                  forward kernel's (bit for bit without a textured mesh);
                  env-terminated and emissive-terminated lanes and albedo
                  factors at every bounce must occur.
26. grad-mesh   — at 256², the fused gradient of mean(color·[1,2,3]) on the
                  textured stand-in under the HDRI (sun NEE) in a quad
                  color, hdr_exposure and the 8 albedo and 8 emissive texels
                  with the largest gradients, against autograd through the
                  plain version (rtol 1e-4) and central differences of the
                  kernel's forward (rtol 2e-2); the mesh translation
                  gradient of the wavefront with the kernel walk against the
                  plain walk (rtol 1e-5).
27. train-textured / train-mesh — apps.inverse_rendering.recover_albedo on
                  the stand-in at 1024², 4 bounces, a 64² albedo: 10 Adam
                  steps of the fused route (loss and albedo error fall) and
                  3 of the wavefront route (loss falls), each route's
                  launches counted (the fused route's backward launches the
                  texel VJP once a frame and bounce, the wavefront's never);
                  3 Adam steps of each other new grads configuration.
28. timing-closest-hit / timing-grads-mesh / timing-inverse-rendering —
                  device time (torch.profiler), time through the wrapper
                  (CUDA events), plain time, bound and share of the
                  closest-hit kernel (primary rays and bounce 2, with the
                  registers, shared memory, stack and spills nvcc reported
                  for it) and of each new grads configuration;
                  the wavefront pass with either walk; the textured
                  inverse-rendering fwd+bwd step of both routes (ms,
                  Mrays/s, peak device memory).  timing-texel-vjp: the
                  albedo samples of one fused step (1024² lanes of the 64²
                  map, about 95% of them unapplied) fed to the texel VJP
                  kernel alone, held to texel_grad_reference within the
                  order bound of tests/test_torch_texel_grad.py, its
                  device time, time through the wrapper, the plain route's
                  time, its bytes bound and the share reached.
29. parity-staged — the staged kernel (K2, csrc/staged.cu) in every K1
                  configuration (Cornell METAL and TRANSPARENT, quadric,
                  sky, the capacity mesh, HDRI sun and env NEE, the
                  textured stand-in under the glTF and the HDRI sun
                  configurations with the lobe): a pool of frames 2 and 3
                  at 1024², 4 bounces, bit-equal frame by frame to two K1
                  launches on every plane, forward and grads mode; the same
                  pool phase by phase: at each boundary the key kernel
                  (csrc/sort_key.cu), from K2's warp boxes and from the
                  rows, bit-equal to sort_key in all three modes and
                  torch.sort's permutations equal, the sort after
                  phase 0 moves lanes; a plain 64² pool's LaneCounts show
                  each configuration's branches; on Cornell and the
                  stand-in, every phase bit-equal to trace_phase_reference
                  from the same sorted state at 256².
30. grad-parity-staged — at 256², render_avg(reorder=True)'s gradients (the
                  Cornell light color; the stand-in's albedo map and a
                  sphere color) within rtol 1e-4 of the monolithic VJP's
                  and 2e-2 of central differences of the staged forward.
31. main-staged — ProgressiveRenderer + attach_cuda_path(reorder=True):
                  render(spp=8, batch=4) of the Cornell box and the
                  capacity mesh bit-equal to sample-at-a-time stepping, one
                  staged launch per phase and pool, one key launch per
                  boundary and pool.
32. train-staged — optimize(reorder=True) on phase 8's emission problem:
                  the loss falls below 5% of its start, through K2 and the
                  key kernel alone.
33. timing-staged — 8 frames in one pool (1024², 4 bounces) against 8 K1
                  launches on the Cornell box (forward and grads), the
                  capacity mesh, its rugged variant and the textured
                  stand-in (forward and grads): pool ms and
                  Mrays/s, each phase, sort key and torch.sort (CUDA
                  events), K2's device time (torch.profiler), its bound and
                  share; on each boundary's state, the key kernel's device
                  time per pass (from K2's boxes, as the pool runs it, and
                  from the rows), its bound (bytes, from the state's live
                  lanes) and the torch sort_key's time; the stand-in's
                  fwd+bwd step
                  w.r.t. its albedo map, staged against monolithic.
34. parity-loop-cost — K5 (csrc/loop_cost.cu, the walk-loop cost
                  microbenchmark, each configuration one thread-block
                  cluster) in its seven configurations against its plain
                  version on the card, bit for bit, at 50 iterations: on the
                  tool's inputs, and on a seeded table whose rows grow or
                  shrink the tile (the any-reduce both set and clear); and
                  at 4 iterations on a shrinking table with one rising
                  element placed in each of the tile's 8 rows in turn (the
                  flag set by one block of the cluster alone).
35. main-loop-cost — the tool's main path, `python -m
                  bpt_tpu_torch.tools.loop_cost --iters 4000`: every
                  configuration launched, the outputs what its data give.
36. timing-loop-cost — per configuration: its mapping (blocks of the
                  cluster, values a thread), ns/iter (CUDA events), device
                  time (torch.profiler), bound and share, the plain version's
                  ns/iter, the SASS's instruction counts (cuobjdump; each
                  instantiation must keep its loop); the cost of one chain
                  step (ns and cycles at the SM clock read under K5's load,
                  from the slope of the CUDA-event ns/iter between ops 100
                  and 320) and each
                  configuration's chain floor; utils.profiling's
                  device_trace writes a Chrome trace that holds the kernel.
37. checkpoint  — a 1024² Cornell ProgressiveRenderer renders 3 frames, is
                  saved with its generator (utils.checkpoint.save_renderer)
                  and loaded into a fresh renderer, which renders 2 more:
                  bit-equal to 5 uninterrupted frames, 10 K1 launches.
38. sharded     — (a) the capacity mesh and the Cornell box at 1024², 4
                  bounces, as four 256-row staged pools at row_offset 0,
                  256, 512, 768 (trace_frames_fused with full_height),
                  joined bit-equal to the K1 frame and to the four plain
                  pools on every plane: 16 K2 phase and 12 key launches a
                  scene, each counted on its own; the pools' phases and
                  K2's device time against one 1024-row pool, the bound
                  and the plain pools.  (b) sharded_render_frame, the light
                  colour's gradient through replicate / sum_over_tiles and
                  sharded_screen_output under a 1-rank NCCL group (the card
                  is one GPU: no multi-GPU number), equal to render_frame,
                  its gradient and screen_output at 1024².  (c) a sharded
                  wavefront frame on the capacity mesh at 256² through K3
                  (4 launches), bit-equal to the plain walk, and a row tile
                  equal to its rows.
39. boundary    — the silhouette and shadow boundary terms (plain torch, no
                  kernel) at 64² on the card, finite and within 1e-4
                  relative of the same call on the CPU.
40. fidelity    — tools.fidelity on the capacity mesh at 256² (K1 against
                  the wavefront through K3: its shares of pixels off by more
                  than 1e-3) and tools.helmet_profile's variants there at
                  the tool's own size (512², 8-frame pools).

It ends with a JSON line of per-kernel results (one entry per mode and
configuration, each with its bound, the least time the card could take for
the same work), the card's name and power limit, and a last JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from bpt_tpu_torch.utils.profiling import event_ms

SIZE = 1024
BOUNCES = 4
SPP = 8
RAND_VEC2 = np.array([0.3, 0.7], np.float32)
GRAD_SIZE = 256
TRAIN_STEPS = 30
TRAIN_FRAMES = (1.0, 2.0)
BENCH_FRAMES = 8
# bench.py's Cornell fwd+bwd step (phase 9) before the parallelogram test:
# its device operations and host synchronizations (tools/ab_time.py
# step_counts on the parent commit, under torch PARENT_STEP_TORCH); the step
# must make no more.  The operations are torch's kernels, copies and
# memsets, so their count holds for that torch only: under another the
# script reports it and compares the host synchronizations alone.
PARENT_STEP_OPS = 325
PARENT_STEP_SYNCS = 0
PARENT_STEP_TORCH = "2.11.0+cu128"

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
ENV = {"none": 0, "sky": 1, "hdri": 2}
NEE = {"quad": 0, "sun": 1, "env": 2}


def instance(grads: bool, env: str, nee: str, mesh: bool, textured: bool = False, kernel: str = "trace_kernel") -> str:
    """The profiler's name of one template instantiation of K1 (``kernel``
    "trace_kernel") or K2 ("phase_kernel"): the kernels without a mesh take
    (grads, env, nee), those with an untextured one (grads, env, nee,
    false); a textured mesh's are kernels of their own ("trace_kernel_textured",
    "phase_kernel_textured") of (grads, env, nee)."""
    args = [str(grads).lower(), str(ENV[env]), str(NEE[nee])] + ([str(textured).lower()] if mesh and not textured
                                                                 else [])
    return f"{kernel}{'_textured' if textured else ''}<{', '.join(args)}>"


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(got, ref) -> dict:
    """Kernel against its plain version.  The stats report the parity
    criterion of the JAX package's kernel tests (>= 99.5% of pixels with color
    within rtol 1e-4 / atol 1e-5, first-hit normals within rtol 1e-3 / atol
    1e-4, object ids equal, >= 99% of sharpness flags equal), but the phase
    demands bit-equality of every output: built without FMA contraction the
    kernel computes what the plain version computes, so a rare branch that
    goes wrong on a few pixels must not hide inside that criterion's slack."""
    close = torch.isclose(got.color, ref.color, rtol=1e-4, atol=1e-5).all(dim=-1)
    normal_ok = torch.isclose(got.object_normal, ref.object_normal, rtol=1e-3, atol=1e-4).all(dim=-1)
    stats = {
        "color_close": close.float().mean().item(),
        "normal_close": normal_ok.float().mean().item(),
        "id_equal": (got.object_id == ref.object_id).float().mean().item(),
        "sharp_equal": (got.pixel_sharpness == ref.pixel_sharpness).float().mean().item(),
        "color_bit_equal": (got.color == ref.color).all(dim=-1).float().mean().item(),
        "max_abs_err": max((g - r).abs().max().item() for g, r in zip(got, ref)),
    }
    ok = (stats["color_close"] > 0.995 and stats["normal_close"] == 1.0 and stats["id_equal"] == 1.0
          and stats["sharp_equal"] > 0.99 and stats["color_bit_equal"] == 1.0 and stats["max_abs_err"] == 0.0)
    return stats | {"ok": ok}


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


def profiled_step(fn, iters: int) -> tuple[float, float, list]:
    """(host ms per call, device-busy ms per call, [(kernel, device ms per
    call, launches per call)] largest first) of ``fn`` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / iters
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            rows.append((ev.key, us / 1e3 / iters, ev.count / iters))
    rows.sort(key=lambda r: -r[1])
    return host_ms, sum(r[1] for r in rows), rows


def kernel_device_ms(fn, iters: int, name: str, tries: int = 3) -> float | None:
    """Mean device time per launch of the CUDA kernels whose name contains
    ``name`` (spaces ignored) while ``fn`` runs; None when the profiler
    reports none.  A profiler session that did not record the kernel (now
    and then a session records no device activity on the card) is run
    again, up to ``tries`` sessions."""
    name = name.replace(" ", "")
    for _ in range(tries):
        rows = [(ms, n) for key, ms, n in profiled_step(fn, iters)[2] if name in key.replace(" ", "")]
        if rows:
            return sum(ms for ms, _ in rows) / sum(n for _, n in rows)
    return None


def nvcc_report(name: str) -> dict:
    """Registers, shared memory (bytes), stack frame and spill stores and
    loads (bytes) that ptxas reported for the first kernel of
    ``csrc/<name>.cu`` in its library's build log."""
    import re

    from bpt_tpu_torch.kernels import build

    log = build.build(name).with_suffix(".so.log").read_text()
    used = re.search(r"Used (\d+) registers[^\n]*", log)  # "..., used 1 barriers, ..., 528 bytes smem"
    smem = re.search(r"(\d+) bytes smem", used.group(0))
    frame, stores, loads = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                                     log).groups()
    return {"registers": int(used.group(1)), "smem_bytes": int(smem.group(1)) if smem else 0,
            "stack_frame_bytes": int(frame), "spill_store_bytes": int(stores), "spill_load_bytes": int(loads)}


def blob_model(T=128, seed=0):
    """The random triangle blob of the JAX package's kernel tests."""
    from bpt_tpu_torch.io.gltf import GLTFModel

    rng = np.random.default_rng(seed)
    c = rng.normal(0, 8, (T, 1, 3)).astype(np.float32)
    tri = (c + rng.normal(0, 3, (T, 3, 3))).astype(np.float32)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-9
    z2 = np.zeros((T, 2), np.float32)
    return GLTFModel(p0=tri[:, 0], p1=tri[:, 1], p2=tri[:, 2], n0=n, n1=n, n2=n, uv0=z2, uv1=z2, uv2=z2,
                     albedo=None, normal_map=None, metallic_roughness=None, emissive=None)


def doubled_model(model):
    """The soup with every triangle twice: triangle i + T is triangle i, so
    every hit is a tie that the walk's visit order decides."""
    return type(model)(*(None if x is None else np.concatenate([x, x]) for x in model))


def one_triangle_model():
    """One large triangle facing the glTF camera: its BVH is one leaf, the
    root."""
    from bpt_tpu_torch.io.gltf import GLTFModel

    p = np.array([[[-30.0, -30.0, 0.0]], [[0.0, 30.0, 0.0]], [[30.0, -30.0, 0.0]]], np.float32)
    n = np.array([[0.0, 0.0, -1.0]], np.float32)
    z2 = np.zeros((1, 2), np.float32)
    return GLTFModel(p0=p[0], p1=p[1], p2=p[2], n0=n, n1=n, n2=n, uv0=z2, uv1=z2, uv2=z2, albedo=None,
                     normal_map=None, metallic_roughness=None, emissive=None)


def tied_lanes(mesh, ro, rd, cull: bool, n: int = 48) -> tuple[int, int]:
    """(lanes looked at, lanes tied): of the first n lanes of a doubled soup
    whose ray hits, those that tested both copies of their winner (the
    copies give the same t bit for bit), by the plain walk's read masks
    (``steps_out``) one lane at a time."""
    from bpt_tpu_torch.accel.traverse import traverse_bvh

    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    walk = (mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max, mesh.p0, mesh.p1, mesh.p2)
    tri = traverse_bvh(*walk, ro, rd, cull)[1]
    half = mesh.p0.shape[0] // 2
    lanes = torch.nonzero(tri >= 0).squeeze(1)[:n].tolist()
    tied = 0
    for lane in lanes:
        steps = []
        traverse_bvh(*walk, ro[lane:lane + 1], rd[lane:lane + 1], cull, steps_out=steps)
        winner = int(tri[lane])
        tied += bool(steps[3][winner]) and bool(steps[3][(winner + half) % (2 * half)])
    return len(lanes), tied


def mesh_and_hdri(card: str, bn: torch.Tensor) -> tuple:
    """Phases 15-18: the mesh and HDRI configurations.  Returns their
    entries of the kernels line and the capacity mesh (host tensors)."""
    import dataclasses

    from bpt_tpu_torch.accel.builder import build_bvh_sah, triangle_aabbs
    from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.integrator.frame import trace_image
    from bpt_tpu_torch.kernels import megakernel, staged
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.gltf_scene import (gltf_camera, gltf_scene, hdri_camera, hdri_scene,
                                                 heightfield_model, mesh_from_model)
    from bpt_tpu_torch.scenes.types import DIFFUSE, METAL, TRANSPARENT

    dev = torch.device("cuda")
    # ---- the native BVH builder on bench.py's capacity mesh -----------------
    model = heightfield_model()
    mn, mx, _ = triangle_aabbs(model.p0, model.p1, model.p2)
    t0 = time.perf_counter()
    bvh = build_bvh_sah(mn, mx, use_native="require")
    build_s = time.perf_counter() - t0
    phase("build", f"native BVH builder (binned SAH): {model.p0.shape[0]} triangles -> {bvh.node_tri.shape[0]} "
                   f"nodes, depth {bvh.max_depth} (stack 28), {build_s:.3f} s")
    if bvh.max_depth >= 28:
        raise AssertionError("the capacity mesh's BVH is deeper than the walk's stack")
    capacity = mesh_from_model(model, mat_type=DIFFUSE, use_native="require")  # host tensors: the renderer moves it
    hdr = synthetic_hdr()
    place = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))
    raised = Camera.look(position=(0.0, 10.0, -70.0), pitch=0.5, fov=0.8, focus_distance=113.0)
    mesh_cfg = IntegratorConfig(bounces=BOUNCES)
    hdri_base = dict(bounces=BOUNCES, env="hdri", diffuse_indirect_max=2)
    sun_cfg = IntegratorConfig(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, **hdri_base)
    env_cfg = IntegratorConfig(nee="env", **hdri_base)
    cap_scene = gltf_scene(capacity, device=dev)
    hdri_cap = hdri_scene(capacity, hdr, device=dev)
    # the demo map's sun lies below the horizon, where no shadow ray reaches it: a sun above it
    hdri_sun_up = hdri_scene(capacity, synthetic_hdr(sun_uv=(0.7, 0.7)), device=dev)
    cases = [  # (family, label, scene, camera, cfg)
        ("mesh", "(a) capacity: heightfield, DIFFUSE, glTF camera", cap_scene, gltf_camera(dev), mesh_cfg),
        ("mesh", "(b) capacity from a raised camera", cap_scene, raised.to(dev), mesh_cfg),
        ("mesh", "(c) blob METAL", gltf_scene(mesh_from_model(blob_model(), mat_type=METAL, **place), device=dev),
         gltf_camera(dev), mesh_cfg),
        ("mesh", "(c) blob TRANSPARENT", gltf_scene(mesh_from_model(blob_model(), mat_type=TRANSPARENT, **place),
                                                    device=dev), gltf_camera(dev), mesh_cfg),
        ("hdri", "nee sun (the demo's)", hdri_cap, hdri_camera(dev), sun_cfg),
        ("hdri", "nee sun, the sun above the horizon", hdri_sun_up, hdri_camera(dev), sun_cfg),
        ("hdri", "nee env", hdri_cap, hdri_camera(dev), env_cfg),
    ]
    pixels = SIZE * SIZE
    errs = {}
    for fam, label, scene, cam, cfg in cases:
        got = megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        lanes = []
        t0 = time.perf_counter()
        ref = trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, lane_counts=lanes, fast_quads=None)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        stats = compare(got, ref)
        mesh_id = float(sum(g.color.shape[0] for g in (scene.spheres, scene.quads) if g is not None))
        share = (ref.object_id == mesh_id).float().mean().item()
        misses = (ref.object_id < -1.0).float().mean().item()
        extra = (f"mesh first hits {share:.4f}, env first-hit misses {misses:.4f}, shadow rays that reached the "
                 f"environment per pixel {sum(int(c.shadow_misses) for c in lanes) / pixels:.4f}, "
                 if fam == "hdri" else f"mesh first hits {share:.4f}, ")
        phase(f"parity-{fam}", f"{label}: {extra}node visits {sum(int(c.node_visits) for c in lanes)}, triangle "
                               f"tests {sum(int(c.tri_tests) for c in lanes)}, plain {plain_s:.2f} s; "
                               + json.dumps(stats))
        if not stats["ok"]:
            raise AssertionError(f"{fam} kernel disagrees with its plain version ({label})")
        if label.startswith("(b)") and share < 0.25:
            raise AssertionError(f"the raised view's mesh share {share} is below 25%")
        if "above the horizon" in label and sum(int(c.shadow_misses) for c in lanes) == 0:
            raise AssertionError("no shadow ray reached the sun above the horizon")
        key = "mesh" if fam == "mesh" else f"hdri_{cfg.nee}"
        errs[key] = max(errs.get(key, 0.0), stats["max_abs_err"])

    # ---- 16. the serving path ------------------------------------------------
    launches = {}
    for key, scene, cam, cfg in (("mesh", gltf_scene(capacity), gltf_camera(), mesh_cfg),
                                 ("hdri_sun", hdri_scene(capacity, hdr), hdri_camera(), sun_cfg),
                                 ("hdri_env", hdri_scene(capacity, hdr), hdri_camera(), env_cfg)):
        fam = key.split("_")[0]
        renderer = ProgressiveRenderer(scene, cfg, SIZE, SIZE)
        if renderer.device.type != "cuda":
            raise AssertionError(f"a renderer with no device argument runs on {renderer.device}")
        megakernel.reset_launches()
        img = renderer.render(cam, spp=SPP)
        torch.cuda.synchronize()
        launches[key] = megakernel.LAUNCHES[fam]
        others = sum(megakernel.LAUNCHES.values()) + sum(megakernel.GRAD_LAUNCHES.values()) - launches[key]
        if launches[key] != SPP or others != 0:
            raise AssertionError(f"{key}: {launches[key]} launches of its configuration, {others} others, for {SPP} "
                                 "frames")
        if not bool(torch.isfinite(img).all()) or img.min().item() < 0.0 or img.max().item() > 1.0:
            raise AssertionError(f"{key}: display is not finite in [0, 1]")
        phase(f"main-{fam}", f"{key} {SIZE}x{SIZE}, {SPP} spp: {launches[key]} launches, display in "
                             f"[{img.min().item():.4f}, {img.max().item():.4f}], mean {img.mean().item():.4f}")

    # ---- 17. timing ---------------------------------------------------------------
    entries = []
    rays = SIZE * SIZE * BOUNCES
    for key, fam, scene, cam, cfg, replaces in (
            ("mesh", "mesh", cap_scene, gltf_camera(dev), mesh_cfg, "bpt_tpu/kernels/megakernel.py:483"),
            ("hdri_sun", "hdri", hdri_cap, hdri_camera(dev), sun_cfg, "bpt_tpu/kernels/megakernel.py:1183"),
            ("hdri_env", "hdri", hdri_cap, hdri_camera(dev), env_cfg, "bpt_tpu/kernels/megakernel.py:2390")):
        def call(scene=scene, cam=cam, cfg=cfg):
            return megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)

        def plain(scene=scene, cam=cam, cfg=cfg):
            return megakernel.trace_image_fused_reference(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)

        ms = event_ms(call, iters=20, warmup=3)
        dev_ms = kernel_device_ms(call, 10, instance(False, cfg.env, cfg.nee, True, False))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak_kernel = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        plain_ms = event_ms(plain, iters=1, warmup=0)
        peak_plain = torch.cuda.max_memory_allocated() / 1e9
        lanes = []
        trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, lane_counts=lanes, fast_quads=None)
        flop, nbytes = kernel_work(lanes, scene.quads.v0.shape[0], scene.spheres.color.shape[0], pixels,
                                   mesh=True, hdri=scene.env if fam == "hdri" else None, env_nee=cfg.nee == "env")
        bound_ms, bound_by = bound(flop, nbytes)
        nodes_read, tris_read, normals_read = mesh_records_read(lanes)
        reached = f"{100 * bound_ms / dev_ms:.1f}%" if dev_ms else "not measured"
        phase(f"timing-{fam}", f"{card}: {key} {SIZE}x{SIZE}, {BOUNCES} bounces: kernel device {dev_ms} ms, through "
                               f"its wrapper {ms:.3f} ms ({rays / ms / 1e3:.1f} Mrays/s), plain {plain_ms:.3f} ms; "
                               f"live lanes {[int(c.live) for c in lanes]}, node visits "
                               f"{[int(c.node_visits) for c in lanes]}, triangle tests "
                               f"{[int(c.tri_tests) for c in lanes]}, misses {[int(c.misses) for c in lanes]}; "
                               f"records read: {nodes_read} of {scene.mesh.node_tri.shape[0]} nodes, {tris_read} "
                               f"triangles and {normals_read} normal records of {scene.mesh.p0.shape[0]}; "
                               f"{flop / 1e9:.4f} GFLOP + {nbytes / 1e6:.3f} MB -> bound {bound_ms:.4f} ms "
                               f"({bound_by}), {reached} of it reached; peak device memory {peak_kernel:.3f} GB "
                               f"(kernel call), {peak_plain:.3f} GB (plain)")
        entries.append({"name": f"megakernel_{key}", "route": "cuda", "source": "bpt_tpu_torch/csrc/megakernel.cu",
                        "replaces": replaces, "launches": launches[key], "max_abs_err": errs[key], "ms": ms,
                        "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})

    # ---- 18. the fused route runs on these scenes; what it cannot carry raises --------
    refused, ran = [], []
    textured = gltf_scene(mesh_from_model(blob_model(8))._replace(albedo=torch.ones(4, 4, 3),
                                                                  normal_map=torch.full((4, 4, 3), 0.5)), device=dev)

    def with_grad(scene, group, field):
        leaf = getattr(getattr(scene, group), field).clone().requires_grad_(True)
        return scene._replace(**{group: getattr(scene, group)._replace(**{field: leaf})}), leaf

    for label, scene, cam, cfg, group, field in (
            ("mesh, a quad color", cap_scene, gltf_camera(dev), mesh_cfg, "quads", "color"),
            ("hdri, hdr_exposure", hdri_cap, hdri_camera(dev), env_cfg, "env", "hdr_exposure"),
            ("textured mesh, the albedo map", textured, gltf_camera(dev), mesh_cfg, "mesh", "albedo")):
        for reorder in (False, True):
            s, leaf = with_grad(scene, group, field)
            out = megakernel.trace_image_fused(s, cam, cfg, 8, 8, 1.0, RAND_VEC2, bn, differentiable=True,
                                               reorder=reorder)
            torch.autograd.grad(out.color.sum(), [leaf])
            ran.append(label + (" (reorder=True)" if reorder else ""))
    for label, error, fn in (
            ("a staged pool whose lanes overflow a 32-bit index", ValueError, lambda: megakernel.trace_frames_fused(
                cap_scene, gltf_camera(dev), mesh_cfg, 65536, 65536, [1.0], [RAND_VEC2], bn)),
            ("a staged pool on a device that is neither CPU nor CUDA", ValueError,
             lambda: staged.trace_staged(cap_scene, gltf_camera(dev), mesh_cfg, 8, 8, [1.0], [RAND_VEC2],
                                         bn.to("meta"))),
            ("a mesh transform that requires a gradient, fused", NotImplementedError,
             lambda: megakernel.trace_image_fused(with_grad(cap_scene, "mesh", "inv_matrix")[0], gltf_camera(dev),
                                                  mesh_cfg, 8, 8, 1.0, RAND_VEC2, bn, differentiable=True)),
            ("vertices that require a gradient, fused", NotImplementedError,
             lambda: megakernel.trace_image_fused(with_grad(cap_scene, "mesh", "p0")[0], gltf_camera(dev),
                                                  mesh_cfg, 8, 8, 1.0, RAND_VEC2, bn, differentiable=True)),
            ("a normal map that requires a gradient, fused", NotImplementedError,
             lambda: megakernel.trace_image_fused(with_grad(textured, "mesh", "normal_map")[0], gltf_camera(dev),
                                                  mesh_cfg, 8, 8, 1.0, RAND_VEC2, bn, differentiable=True)),
            ("metal_roughness_lobe without a textured mesh", ValueError, lambda: megakernel.trace_image_fused(
                cap_scene, gltf_camera(dev), dataclasses.replace(mesh_cfg, metal_roughness_lobe=True), 8, 8, 1.0,
                RAND_VEC2, bn))):
        try:
            fn()
        except error:
            refused.append(f"{error.__name__} for {label}")
        else:
            raise AssertionError(f"{label} did not raise {error.__name__}")
    phase("refusals", f"differentiable=True ran with gradients on: {', '.join(ran)}; raised: {', '.join(refused)}")
    return entries, capacity


def textured_stand_in(model, size: int = 2048, seed: int = 6):
    """The heightfield ``model`` as a textured model at the reference's
    capacity: planar UVs (x, z) tiled 4x across it and offset so that they
    run from -0.5 to 3.5 and from -0.3 to 3.7, and four ``size``² maps (the
    Damaged Helmet's size) made from ``seed``: a smooth albedo; a bump map;
    a metallic-roughness map of 8x8-texel cells (a heightfield triangle
    spans about 16 texels, so classes change inside triangles), each cell
    DIFFUSE, CLEARCOAT_DIFFUSE or METAL with a roughness that varies across
    it; an emissive map with 3% of its cells lit."""
    rng = np.random.default_rng(seed)

    def uv(p):
        return np.stack([(p[:, 0] + 45.0) / 90.0 * 4.0 - 0.5, (p[:, 2] + 45.0) / 90.0 * 4.0 - 0.3],
                        -1).astype(np.float32)

    t = (np.arange(size, dtype=np.float32) + 0.5) / size
    x, y = t[None, :], t[:, None]  # columns u, rows v
    two_pi = np.float32(2.0 * np.pi)
    ones = np.ones((size, size), np.float32)
    albedo = np.stack([0.55 + 0.3 * np.sin(two_pi * (3 * x + 2 * y)), 0.5 + 0.3 * np.cos(two_pi * (2 * x - 5 * y)),
                       0.45 + 0.25 * np.sin(two_pi * 7 * x) * np.cos(two_pi * 4 * y)], -1)
    normal = np.stack([0.5 + 0.3 * np.sin(two_pi * 96 * x) * np.cos(two_pi * 64 * y),
                       0.5 + 0.3 * np.cos(two_pi * 80 * x + 1.0) * np.sin(two_pi * 112 * y), ones], -1)
    cells = size // 8
    block = np.ones((8, 8), np.float32)
    cls = np.kron(rng.integers(0, 3, (cells, cells)), block)
    rough = np.kron(rng.uniform(0.05, 0.9, (cells, cells)), block) * (0.75 + 0.25 * np.sin(two_pi * 512 * x))
    metal = np.kron(rng.uniform(0.5, 1.0, (cells, cells)), block)
    metal_rough = np.stack([0.0 * ones, np.where(cls >= 1, rough, 0.0), np.where(cls == 2, metal, 0.0)], -1)
    lit = np.kron(rng.uniform(0, 1, (cells, cells)) < 0.03, block) > 0
    emissive = np.where(lit[..., None], np.array([0.9, 0.7, 0.4], np.float32), 0.0)
    maps = {name: np.ascontiguousarray(a, np.float32) for name, a in (
        ("albedo", albedo), ("normal_map", normal), ("metallic_roughness", metal_rough), ("emissive", emissive))}
    return model._replace(uv0=uv(model.p0), uv1=uv(model.p1), uv2=uv(model.p2), **maps)


def textured_parity(scene, cam, cfg, size: int, bn: torch.Tensor, label: str):
    """K1's forward and grads kernels on a textured ``scene`` against their
    plain versions at size², frame 2: every plane bit for bit (raises
    otherwise).  Returns (max abs error, the forward kernel's result)."""
    from bpt_tpu_torch.kernels import megakernel

    got = megakernel.trace_image_fused(scene, cam, cfg, size, size, 2.0, RAND_VEC2, bn)
    ref = megakernel.trace_image_fused_reference(scene, cam, cfg, size, size, 2.0, RAND_VEC2, bn)
    g, sg, deferred = megakernel.trace_image_fused_grads(scene, cam, cfg, size, size, 2.0, RAND_VEC2, bn)
    r, sg_ref, deferred_ref = megakernel.trace_image_fused_grads_reference(scene, cam, cfg, size, size, 2.0,
                                                                           RAND_VEC2, bn)
    torch.cuda.synchronize()
    pairs = list(zip(got, ref)) + list(zip(tuple(g) + (sg, deferred), tuple(r) + (sg_ref, deferred_ref)))
    err = max((a - b).abs().max().item() for a, b in pairs)
    stats = compare(got, ref)
    phase("parity-textured", f"{label}: forward and grads {size}x{size}, every plane vs plain max_abs_err {err}; "
                             + json.dumps(stats))
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"textured kernel disagrees with its plain version ({label})")
    return err, got


def texel_table_cases(gltf, cam, bn: torch.Tensor) -> dict:
    """Phase 19's texel-table cases on the stand-in ``gltf`` (on the card):
    the tables' build time and memory, maps of three sizes, and maps edited
    between two launches.  Returns their max abs errors."""
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import launch_args
    from bpt_tpu_torch.scenes.types import MAP_FIELDS
    from bpt_tpu_torch.textures import texel_quads

    mesh = gltf.mesh
    for label, maps in (("forward", [getattr(mesh, m) for m in MAP_FIELDS]),
                        ("grads", [None] + [getattr(mesh, m) for m in MAP_FIELDS[1:]])):
        [texel_quads(t) for t in maps if t is not None]  # warm: the allocator's first blocks
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables = [texel_quads(t) for t in maps if t is not None]
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        table_mb = sum(q.numel() * 4 for q in tables) / 1e6
        map_mb = sum(t.numel() * 4 for t in maps if t is not None) / 1e6
        names = ", ".join(m for m, t in zip(MAP_FIELDS, maps) if t is not None)
        phase("parity-textured", f"texel tables, {label} ({names}): {[tuple(q.shape) for q in tables]}, "
                                 f"{table_mb:.1f} MB for {map_mb:.1f} MB of maps, built in {build_ms:.3f} ms")
        del tables
    cfg = IntegratorConfig(bounces=BOUNCES, metal_roughness_lobe=True)
    errs = {}
    mixed = gltf._replace(mesh=mesh._replace(normal_map=mesh.normal_map[::2, ::2].contiguous(),
                                             emissive=mesh.emissive[::4, ::2].contiguous()))
    tables = launch_args.texel_table_of(mixed.mesh)
    errs["textured_mixed_sizes"], _ = textured_parity(mixed, cam, cfg, GRAD_SIZE, bn, "maps of three sizes, tables "
                                                      f"{[tuple(q.shape) for q in tables]}")
    edited = gltf._replace(mesh=mesh._replace(albedo=mesh.albedo.clone(), normal_map=mesh.normal_map.clone()))
    _, first = textured_parity(edited, cam, cfg, GRAD_SIZE, bn, "maps before the edit")
    edited.mesh.albedo.mul_(0.5)
    flipped = torch.flip(edited.mesh.normal_map, (1,)).contiguous()
    edited = edited._replace(mesh=edited.mesh._replace(normal_map=flipped))
    errs["textured_edited_maps"], second = textured_parity(edited, cam, cfg, GRAD_SIZE, bn,
                                                           "the albedo halved in place, the normal map replaced")
    if torch.equal(first.color, second.color) or torch.equal(first.object_normal, second.object_normal):
        raise AssertionError("the edited maps were not repacked: the launch after the edit equals the one before")
    return errs


def textured_and_camera(card: str, bn: torch.Tensor) -> tuple:
    """Phases 19-22: the textured configuration and the camera cases.
    Returns the textured entry of the kernels line, the textured stand-in's
    model and its mesh (host tensors)."""
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.integrator.frame import trace_image
    from bpt_tpu_torch.kernels import megakernel
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu_torch.scenes.gltf_scene import gltf_scene, hdri_scene, heightfield_model, mesh_from_model
    from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene
    from bpt_tpu_torch.scenes.types import DIFFUSE, MAP_FIELDS, TRANSPARENT

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = textured_stand_in(heightfield_model())
    mesh = mesh_from_model(model, mat_type=DIFFUSE, use_native="require")  # host tensors: the renderer moves them
    gltf = gltf_scene(mesh, device=dev)
    hdri = hdri_scene(mesh, synthetic_hdr(sun_uv=(0.7, 0.7)), device=dev)  # the sun above the horizon
    table_mb = sum(t.numel() * 4 for t in megakernel.pack_mesh(gltf.mesh)[1][:4] if t is not None) / 1e6
    map_mb = sum(getattr(gltf.mesh, m).numel() * 4 for m in MAP_FIELDS) / 1e6  # the texel table: below
    shapes = [tuple(getattr(model, m).shape) for m in MAP_FIELDS]
    phase("parity-textured", f"stand-in: {model.p0.shape[0]} triangles, maps {shapes}, u in "
                             f"[{model.uv0[:, 0].min():.2f}, {model.uv0[:, 0].max():.2f}], v in "
                             f"[{model.uv0[:, 1].min():.2f}, {model.uv0[:, 1].max():.2f}], kernel tables "
                             f"{table_mb:.1f} MB, maps {map_mb:.1f} MB, built in "
                             f"{time.perf_counter() - t0:.1f} s")
    raised = Camera.look(position=(0.0, 10.0, -70.0), pitch=0.5, fov=0.8, focus_distance=113.0)
    hdri_base = dict(bounces=BOUNCES, env="hdri", diffuse_indirect_max=2, metal_roughness_lobe=True)
    host_hdri = hdri_scene(mesh, synthetic_hdr(sun_uv=(0.7, 0.7)))
    sky_cfg = IntegratorConfig(bounces=BOUNCES, env="sky", nee="sun", metal_roughness_lobe=True)
    cases = [  # (key, scene on the card, scene on the host, cfg)
        ("textured", gltf, gltf_scene(mesh), IntegratorConfig(bounces=BOUNCES, metal_roughness_lobe=True)),
        ("textured_hdri_sun", hdri, host_hdri,
         IntegratorConfig(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, **hdri_base)),
        ("textured_hdri_env", hdri, host_hdri, IntegratorConfig(nee="env", **hdri_base)),
    ]
    sky_case = ("textured_sky", physical_sky_scene(device=dev)._replace(mesh=gltf.mesh), None, sky_cfg)
    pixels, rays = SIZE * SIZE, SIZE * SIZE * BOUNCES
    cam = raised.to(dev)
    errs, lanes_of = {}, {}
    for key, scene, _, cfg in cases + [sky_case]:
        if megakernel.configuration(scene, cfg) != "textured":
            raise AssertionError(f"{key} does not run the textured configuration")
        got = megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        lanes = []
        t0 = time.perf_counter()
        ref = trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, lane_counts=lanes, fast_quads=None)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        stats = compare(got, ref)
        mesh_id = float(sum(g.color.shape[0] for g in (scene.spheres, scene.quads) if g is not None))
        share = (ref.object_id == mesh_id).float().mean().item()
        classes = [int(x) for x in sum(c.pbr_classes for c in lanes)]
        emissive = sum(int(c.emissive_hits) for c in lanes)
        lobe = sum(int(c.lobe_draws) for c in lanes)
        samples = [int(x) for x in sum(c.texel_samples for c in lanes)]
        phase("parity-textured", f"{key}: mesh first hits {share:.4f}; PBR hits decided DIFFUSE / CLEARCOAT / METAL "
                                 f"{classes}, emissive terminations {emissive}, lobe draws with roughness > 0 {lobe}, "
                                 f"texel samples an output reads (albedo, normal, metallic-roughness, emissive; "
                                 f"the normal map on no shadow ray, the emissive map on specular paths) {samples}, "
                                 f"distinct "
                                 f"texels read {texels_read(lanes)}; plain {plain_s:.2f} s; " + json.dumps(stats))
        if not stats["ok"]:
            raise AssertionError(f"textured kernel disagrees with its plain version ({key})")
        if min(classes) == 0 or emissive == 0 or lobe == 0 or min(samples) == 0:
            raise AssertionError(f"{key}: a branch did not fire (classes {classes}, emissive {emissive}, lobe {lobe}, "
                                 f"samples {samples})")
        errs[key], lanes_of[key] = stats["max_abs_err"], lanes
    # a normal map without an albedo: the textured configuration keeps the mesh's own material (TRANSPARENT:
    # double-sided, refracting) and decodes no PBR texel
    bump = gltf_scene(mesh._replace(albedo=None, metallic_roughness=None, emissive=None,
                                    mat_type=torch.tensor(TRANSPARENT, dtype=torch.int32)), device=dev)
    cfg = IntegratorConfig(bounces=BOUNCES)
    if megakernel.configuration(bump, cfg) != "textured":
        raise AssertionError("a normal map alone does not run the textured configuration")
    got = megakernel.trace_image_fused(bump, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
    lanes = []
    ref = trace_image(bump, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, lane_counts=lanes, fast_quads=None)
    torch.cuda.synchronize()
    stats = compare(got, ref)
    samples = [int(x) for x in sum(c.texel_samples for c in lanes)]
    classes = [int(x) for x in sum(c.pbr_classes for c in lanes)]
    phase("parity-textured", f"normal map only, TRANSPARENT: texel samples {samples}, PBR hits {classes}; "
                             + json.dumps(stats))
    if not stats["ok"]:
        raise AssertionError("textured kernel disagrees with its plain version (normal map only)")
    if samples[1] == 0 or sum(samples) != samples[1] or sum(classes) != 0:
        raise AssertionError(f"normal map only: texel samples {samples}, PBR hits {classes}")
    errs["textured_normal_only"] = stats["max_abs_err"]
    del bump, got, ref
    errs.update(texel_table_cases(gltf, cam, bn))

    # ---- 20. the serving path ------------------------------------------------
    launches = {}
    for key, _, host_scene, cfg in cases:
        renderer = ProgressiveRenderer(host_scene, cfg, SIZE, SIZE)
        megakernel.reset_launches()
        img = renderer.render(raised, spp=SPP)
        torch.cuda.synchronize()
        launches[key] = megakernel.LAUNCHES["textured"]
        others = sum(megakernel.LAUNCHES.values()) + sum(megakernel.GRAD_LAUNCHES.values()) - launches[key]
        if renderer.device.type != "cuda" or launches[key] != SPP or others != 0:
            raise AssertionError(f"{key}: {launches[key]} textured launches, {others} others, for {SPP} frames on "
                                 f"{renderer.device}")
        if not bool(torch.isfinite(img).all()) or img.min().item() < 0.0 or img.max().item() > 1.0:
            raise AssertionError(f"{key}: display is not finite in [0, 1]")
        frame_ms = event_ms(lambda: renderer.render_sample(raised), iters=10, warmup=2)
        phase("main-textured", f"{key} {SIZE}x{SIZE}, {SPP} spp: {launches[key]} launches, display in "
                               f"[{img.min().item():.4f}, {img.max().item():.4f}], mean {img.mean().item():.4f}; "
                               f"progressive frame {frame_ms:.3f} ms")
        del renderer

    # ---- 21. timing -----------------------------------------------------------
    entries = []
    for key, scene, _, cfg in cases:
        def call(scene=scene, cfg=cfg):
            return megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)

        ms = event_ms(call, iters=20, warmup=3)
        dev_ms = kernel_device_ms(call, 10, instance(False, cfg.env, cfg.nee, True, True))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak_kernel = torch.cuda.max_memory_allocated() / 1e9
        plain_ms = event_ms(lambda: megakernel.trace_image_fused_reference(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2,
                                                                          bn), iters=1, warmup=0)
        lanes = lanes_of[key]
        flop, nbytes = kernel_work(lanes, scene.quads.v0.shape[0], scene.spheres.color.shape[0], pixels, mesh=True,
                                   hdri=scene.env if cfg.env == "hdri" else None, env_nee=cfg.nee == "env",
                                   textured=True)
        bound_ms, bound_by = bound(flop, nbytes)
        reached = f"{100 * bound_ms / dev_ms:.2f}%" if dev_ms else "not measured"
        phase("timing-textured", f"{card}: {key} {SIZE}x{SIZE}, {BOUNCES} bounces: kernel device {dev_ms} ms, "
                                 f"through its wrapper {ms:.3f} ms ({rays / ms / 1e3:.1f} Mrays/s), plain "
                                 f"{plain_ms:.3f} ms; live lanes {[int(c.live) for c in lanes]}, node visits "
                                 f"{[int(c.node_visits) for c in lanes]}, texel samples "
                                 f"{[c.texel_samples.tolist() for c in lanes]}; {flop / 1e9:.4f} GFLOP + "
                                 f"{nbytes / 1e6:.3f} MB -> bound {bound_ms:.4f} ms ({bound_by}), {reached} of it "
                                 f"reached; peak device memory {peak_kernel:.3f} GB (kernel call)")
        if key == "textured":  # the same geometry and view untextured (DIFFUSE), for what the texels cost
            bare = dict(albedo=None, normal_map=None, metallic_roughness=None, emissive=None)
            tables = scene.mesh.kernel_tables
            plain_mesh = scene._replace(mesh=scene.mesh._replace(
                kernel_tables=None if tables is None else tables._replace(uvs=None), **bare))
            untextured_ms = kernel_device_ms(
                lambda: megakernel.trace_image_fused(plain_mesh, cam, IntegratorConfig(bounces=BOUNCES), SIZE, SIZE,
                                                     2.0, RAND_VEC2, bn), 10, instance(False, "none", "quad", True))
            phase("timing-textured", f"{card}: the same mesh and camera untextured (DIFFUSE, no lobe): kernel "
                                     f"device {untextured_ms} ms")
            entries.append({"name": "megakernel_textured", "route": "cuda",
                            "source": "bpt_tpu_torch/csrc/megakernel.cu",
                            "replaces": "bpt_tpu/kernels/megakernel.py:1183", "launches": launches[key],
                            "max_abs_err": max(errs.values()), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                            "launches_hdri_sun": launches["textured_hdri_sun"],
                            "launches_hdri_env": launches["textured_hdri_env"]})
    del gltf, hdri, cases

    # ---- 22. the thin lens and camera_is_moving on the Cornell kernel ------
    lens = cornell_camera(device=dev)._replace(aperture_size=torch.tensor(1.0, device=dev),
                                               focus_distance=torch.tensor(100.0, device=dev))
    if not float(lens.aperture_size) > 0.0:
        raise AssertionError("the thin-lens case has no aperture")
    glass = cornell_scene(right_sphere_mat=TRANSPARENT, device=dev)
    for label, lens_cam, cfg in (("thin lens, aperture 1, focus 100", lens, IntegratorConfig(bounces=BOUNCES)),
                                 ("camera_is_moving", cornell_camera(device=dev),
                                  IntegratorConfig(bounces=BOUNCES, camera_is_moving=True))):
        got = megakernel.trace_image_fused(glass, lens_cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        ref = megakernel.trace_image_fused_reference(glass, lens_cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        torch.cuda.synchronize()
        stats = compare(got, ref)
        phase("parity-camera", f"{label}: " + json.dumps(stats))
        if not stats["ok"]:
            raise AssertionError(f"the Cornell kernel disagrees with its plain version ({label})")
    return entries, model, mesh


def closest_hit_work(ro, rd, cull: bool, active, mesh) -> tuple[float, float, list, dict]:
    """(FP32 operations, bytes, [inner-node visits, triangle tests], the
    walks' lengths) of one closest-hit launch on these rays, from the plain
    walk's counts: the
    walk's operations per lane, visit and test (as ``kernel_work`` counts
    them for the megakernel), each live lane's ray and the lane mask (when
    there is one) read once, each lane's result written once, and each
    distinct 32-byte node box (as ``kernel_work`` counts it) and 48-byte
    triangle record read.  The lengths: lanes on the mask, lanes that walk
    (enter the root box), and the steps (visits plus tests) of a walking
    lane, mean, 99th percentile and most: a warp lasts as long as its
    longest walk."""
    from bpt_tpu_torch.accel.traverse import MAX_STACK_DEPTH, traverse_bvh

    steps = []
    traverse_bvh(mesh.node_tri, mesh.node_right, mesh.node_min, mesh.node_max, mesh.p0, mesh.p1, mesh.p2, ro, rd,
                 cull, MAX_STACK_DEPTH, active=active, steps_out=steps)
    visits, tests = int(steps[0].sum()), int(steps[1].sum())
    lanes = ro[..., 0].numel()
    live = lanes if active is None else int(active.sum())
    flop = live * CH_RAY_FLOP + visits * NODE_VISIT_FLOP + tests * TRI_TEST_FLOP
    nbytes = (live * CH_RAY_BYTES + (0 if active is None else lanes) + lanes * CH_RESULT_BYTES
              + 32 * int(steps[2].sum()) + 48 * int(steps[3].sum()))
    per_lane = (steps[0] + steps[1]).reshape(-1)
    walking = per_lane[per_lane > 0].double()
    lengths = {"live": live, "walking": int(walking.numel()),
               "mean_steps": round(walking.mean().item(), 2) if walking.numel() else 0.0,
               "p99_steps": walking.quantile(0.99).item() if walking.numel() else 0.0,
               "max_steps": int(walking.max().item()) if walking.numel() else 0}
    return flop, nbytes, [visits, tests], lengths


def inference_mode_path(card: str, bn: torch.Tensor, capacity, stand_in) -> None:
    """Phase 22b: K1 under torch.inference_mode on the capacity mesh (glTF
    camera) and on the textured stand-in (the raised camera, the lobe on).
    Their tensors moved to the card inside inference mode keep no version
    counter, so every launch makes the mesh's kernel tables (and the
    stand-in's texel tables) anew: each frame is bit-equal to the frame of
    the same scene made outside inference mode, whose tables stay resident.
    Times (CUDA events) one mesh_tables build, one texel-table build and a
    K1 launch in each mode, and under torch.no_grad."""
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import launch_args, megakernel
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene
    from bpt_tpu_torch.scenes.types import mesh_tables

    dev = torch.device("cuda")
    raised = Camera.look(position=(0.0, 10.0, -70.0), pitch=0.5, fov=0.8, focus_distance=113.0).to(dev)
    cases = (("capacity", capacity, gltf_camera(dev), IntegratorConfig(bounces=BOUNCES), "mesh"),
             ("textured stand-in", stand_in, raised, IntegratorConfig(bounces=BOUNCES, metal_roughness_lobe=True),
              "textured"))
    for label, model_mesh, cam, cfg, family in cases:
        outside = gltf_scene(model_mesh, device=dev)
        with torch.inference_mode():
            inside = gltf_scene(model_mesh, device=dev)
        if outside.mesh.kernel_tables is None or inside.mesh.kernel_tables is not None:
            raise AssertionError(f"inference mode, {label}: Scene.to made tables for inference tensors, or none "
                                 f"for normal ones")

        def frame(scene, mode=None):
            def call():
                with mode() if mode else contextlib.nullcontext():
                    return megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
            return call

        def in_inference(fn):
            def call():
                with torch.inference_mode():
                    return fn()
            return call

        want = frame(outside)()
        before = megakernel.LAUNCHES[family]
        got = frame(inside, torch.inference_mode)()
        torch.cuda.synchronize()
        if megakernel.LAUNCHES[family] != before + 1 or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"inference mode, {label}: the K1 frame is not the frame made outside it")
        resident_ms = event_ms(frame(outside), iters=5, warmup=1)
        no_grad_ms = event_ms(frame(outside, torch.no_grad), iters=5, warmup=1)
        inference_ms = event_ms(frame(inside, torch.inference_mode), iters=5, warmup=1)
        tables_ms = event_ms(in_inference(lambda: mesh_tables(inside.mesh)), iters=5, warmup=1)
        line = (f"{card}: {label}, {int(model_mesh.p0.shape[0])} triangles, {SIZE}x{SIZE}, {BOUNCES} bounces: "
                f"K1 frame under inference_mode bit-equal to the frame outside it; a K1 launch "
                f"{resident_ms:.3f} ms with resident tables, {no_grad_ms:.3f} ms under no_grad, {inference_ms:.3f} ms "
                f"under inference_mode (tables made each launch); one mesh_tables build {tables_ms:.3f} ms")
        if family == "textured":
            texels_ms = event_ms(in_inference(lambda: launch_args.texel_table_of(inside.mesh)), iters=5, warmup=1)
            line += f", one texel-table build (4 maps) {texels_ms:.3f} ms"
        phase("inference-mode", line + " (CUDA events)")
        del outside, inside, got, want


def inverse_rendering(card: str, bn: torch.Tensor, capacity, stand_in, stand_in_model) -> list:
    """Phases 23-28: the wavefront closest-hit kernel, the grads mode of the
    mesh, HDRI and textured configurations, their gradients and the textured
    inverse-rendering cell.  ``capacity`` and ``stand_in`` are the capacity
    mesh and the textured stand-in (host tensors), ``stand_in_model`` the
    stand-in's model.  Returns their entries of the kernels line."""
    import dataclasses

    from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
    from bpt_tpu_torch.apps.inverse_rendering import recover_albedo
    from bpt_tpu_torch.camera import Camera, generate_rays
    from bpt_tpu_torch.core.rng import rng_seed
    from bpt_tpu_torch.core.vecmath import transform_dir, transform_point
    from bpt_tpu_torch.diff.inverse import optimize, render_avg
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.integrator.frame import pixel_grid, trace_image
    from bpt_tpu_torch.kernels import megakernel, texel_grad
    from bpt_tpu_torch.kernels import traverse as closest_hit
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, hdri_camera, hdri_scene, mesh_from_model
    from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene
    from bpt_tpu_torch.scenes.types import DIFFUSE, METAL, TRANSPARENT
    from bpt_tpu_torch.tools.ab_time import bounce_rays

    dev = torch.device("cuda")
    raised = Camera.look(position=(0.0, 10.0, -70.0), pitch=0.5, fov=0.8, focus_distance=113.0).to(dev)
    place = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))
    cap = gltf_scene(capacity, device=dev)
    tex = gltf_scene(stand_in, device=dev)
    pixels = SIZE * SIZE

    def primary(mesh, cam, height=SIZE, width=SIZE):
        """Primary rays of frame 2 (1024² unless told) in the mesh's object
        space."""
        px, py = pixel_grid(height, width, dev)
        ro, rd, _ = generate_rays(cam, px, py, width, height, rng_seed(2.0, px, py))
        return transform_point(mesh.inv_matrix, ro), transform_dir(mesh.inv_matrix, rd)

    # ---- 23. the closest-hit kernel against the plain walk ---------------------------
    blobs = {mat: gltf_scene(mesh_from_model(blob_model(), mat_type=mat, **place), device=dev).mesh
             for mat in (METAL, TRANSPARENT)}
    doubled = gltf_scene(mesh_from_model(doubled_model(blob_model(64)), mat_type=DIFFUSE, **place), device=dev).mesh
    one = gltf_scene(mesh_from_model(one_triangle_model(), mat_type=DIFFUSE, translation=place["translation"]),
                     device=dev).mesh
    # bounce 2: the lanes whose shadow ray failed at bounce 1 are off the mask (from the glTF camera no
    # primary ray ends on the light)
    ro_b, rd_b, act_b = bounce_rays(cap, gltf_camera(dev), IntegratorConfig(bounces=BOUNCES), SIZE, RAND_VEC2, bn, 2)
    cases = [("capacity, primary rays, glTF camera", cap.mesh, *primary(cap.mesh, gltf_camera(dev)), None),
             ("capacity, primary rays, raised camera", cap.mesh, *primary(cap.mesh, raised), None),
             ("capacity, bounce 2 of a plain pass, its live lanes only", cap.mesh, ro_b, rd_b, act_b),
             ("blob METAL, primary rays", blobs[METAL], *primary(blobs[METAL], gltf_camera(dev)), None),
             ("blob TRANSPARENT (cull off), primary rays", blobs[TRANSPARENT],
              *primary(blobs[TRANSPARENT], gltf_camera(dev)), None),
             ("textured stand-in, primary rays, raised camera", tex.mesh, *primary(tex.mesh, raised), None),
             ("blob with every triangle twice (ties), primary rays", doubled, *primary(doubled, gltf_camera(dev)),
              None),
             ("one triangle (the root a leaf), primary rays", one, *primary(one, gltf_camera(dev)), None),
             ("capacity, primary rays of a 1021x997 image, glTF camera", cap.mesh,
              *primary(cap.mesh, gltf_camera(dev), 1021, 997), None),
             ("capacity, bounce 2 as flat (1000003, 3) rays, its live lanes only", cap.mesh,
              ro_b.reshape(-1, 3)[:1000003], rd_b.reshape(-1, 3)[:1000003], act_b.reshape(-1)[:1000003])]
    ch_err, plain_times, ch_timing = 0.0, {}, {}
    for label, mesh, ro, rd, act in cases:
        cull = mesh.albedo is not None or int(mesh.mat_type) != TRANSPARENT
        got = closest_hit.closest_hit(ro, rd, cull, act, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = closest_hit.closest_hit_reference(ro, rd, cull, act, mesh)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_times[label] = plain_s * 1e3
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        ch_err = max(ch_err, max((a.double() - b.double()).abs().max().item() for a, b in zip(got, ref)))
        hits = int((got[1] >= 0).sum())
        masked = ("" if act is None else
                  f", {int((~act).sum())} lanes masked, all missing: {bool((got[1][~act] < 0).all())}")
        phase("parity-closest-hit", f"{label}: {hits} of {got[1].numel()} lanes hit{masked}, t/tri/u/v bit-equal "
                                    f"{equal}, plain walk {plain_s:.2f} s")
        if not equal or hits == 0 or (act is not None and not (bool((got[1][~act] < 0).all()) and (~act).any())):
            raise AssertionError(f"the closest-hit kernel disagrees with the plain walk ({label})")
        if mesh is doubled:
            looked, tied = tied_lanes(mesh, ro, rd, cull)
            phase("parity-closest-hit", f"{label}: {tied} of the first {looked} hit lanes tested both copies of "
                                        f"their winner (a tie the visit order decides)")
            if looked == 0 or tied < 0.8 * looked:
                raise AssertionError("the doubled soup reached too few ties")
        if label in (cases[0][0], cases[2][0]):  # timed here, next to the parity run (phase 28 reports)
            def call(mesh=mesh, ro=ro, rd=rd, act=act, cull=cull):
                return closest_hit.closest_hit(ro, rd, cull, act, mesh)

            ch_timing[label] = (event_ms(call, iters=20, warmup=3), kernel_device_ms(call, 10, "closest_hit_kernel"))
    # the recompute VJP on the card against the same backward on CPU copies
    ro, rd = primary(cap.mesh, raised)
    ro, rd = ro.clone().requires_grad_(True), rd.clone().requires_grad_(True)
    t, tri, u, v = closest_hit.closest_hit(ro, rd, True, None, cap.mesh)
    w = torch.randn(3, *t.shape, device=dev, generator=torch.Generator(dev).manual_seed(3))
    g_card = torch.autograd.grad((torch.where(tri >= 0, t, 0.0) * w[0] + u * w[1] + v * w[2]).sum(), [ro, rd])
    cpu = [x.detach().cpu() for x in (ro, rd, cap.mesh.p0, cap.mesh.p1, cap.mesh.p2, tri)]
    g_cpu = closest_hit.recompute_vjp(cpu[0], cpu[1], cpu[2:5], cpu[5],
                                      (torch.where(cpu[5] >= 0, w[0].cpu(), 0.0), w[1].cpu(), w[2].cpu()),
                                      (True, True, False, False, False))
    vjp_err = max(((a.cpu() - b).abs() / b.abs().clamp_min(1e-6)).max().item() for a, b in zip(g_card, g_cpu))
    phase("parity-closest-hit", f"recompute VJP, {int((tri >= 0).sum())} hit lanes: (g_ro, g_rd) on the card vs the "
                                f"CPU backward, max relative difference {vjp_err:.3e}")
    if not vjp_err <= 1e-5:
        raise AssertionError("the closest-hit VJP on the card disagrees with the CPU backward")

    # ---- 24. the wavefront pass with the kernel walk against the plain walk ----------
    wf_cfg = IntegratorConfig(bounces=BOUNCES)
    lobe_cfg = IntegratorConfig(bounces=BOUNCES, metal_roughness_lobe=True)
    wavefront = {}
    for key, scene, cam, cfg in (("capacity", cap, gltf_camera(dev), wf_cfg), ("textured", tex, raised, lobe_cfg)):
        closest_hit.reset_launches()
        megakernel.reset_launches()
        got = trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        torch.cuda.synchronize()
        per_pass = closest_hit.LAUNCHES["closest_hit"]
        others = sum(megakernel.LAUNCHES.values()) + sum(megakernel.GRAD_LAUNCHES.values())
        t0 = time.perf_counter()
        ref = trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, plain_walk=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        stats = compare(got, ref)
        kernel_ms = event_ms(lambda: trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn), iters=3, warmup=1)
        wavefront[key] = (kernel_ms, plain_ms)
        phase("wavefront-mesh", f"{card}: {key} {SIZE}x{SIZE}, {BOUNCES} bounces: trace_image with the kernel walk "
                                f"{kernel_ms:.3f} ms, with the plain walk {plain_ms:.3f} ms; closest-hit launches per "
                                f"pass {per_pass}, megakernel launches {others}; " + json.dumps(stats))
        if not stats["ok"] or per_pass != BOUNCES or others != 0:
            raise AssertionError(f"the wavefront pass with the kernel walk disagrees ({key}: {per_pass} launches)")

    # ---- 25. the grads mode of the new configurations against its plain version ------
    hdri_base = dict(bounces=BOUNCES, env="hdri", diffuse_indirect_max=2)
    sun_cfg = IntegratorConfig(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, **hdri_base)
    env_cfg = IntegratorConfig(nee="env", **hdri_base)
    sun_up = synthetic_hdr(sun_uv=(0.7, 0.7))  # the sun above the horizon
    hdri_cap = hdri_scene(capacity, sun_up, device=dev)
    hdri_tex = hdri_scene(stand_in, sun_up, device=dev)
    sky_mesh = physical_sky_scene(device=dev)._replace(mesh=cap.mesh)
    lobe = dict(metal_roughness_lobe=True)
    grads_cases = [  # (key, scene, camera, cfg)
        ("mesh", cap, gltf_camera(dev), wf_cfg),
        ("hdri_sun", hdri_cap, hdri_camera(dev), sun_cfg),
        ("hdri_env", hdri_cap, hdri_camera(dev), env_cfg),
        ("sky_mesh", sky_mesh, raised, IntegratorConfig(bounces=BOUNCES, env="sky", nee="sun")),
        ("textured", tex, raised, lobe_cfg),
        ("textured_hdri_sun", hdri_tex, raised, dataclasses.replace(sun_cfg, **lobe)),
        ("textured_hdri_env", hdri_tex, raised, dataclasses.replace(env_cfg, **lobe)),
        ("textured_sky", physical_sky_scene(device=dev)._replace(mesh=tex.mesh), raised,
         IntegratorConfig(bounces=BOUNCES, env="sky", nee="sun", **lobe)),
    ]
    grads_info = {}
    for key, scene, cam, cfg in grads_cases:
        got, sg, deferred = megakernel.trace_image_fused_grads(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        lanes = []
        t0 = time.perf_counter()
        ref, sg_ref, deferred_ref = megakernel.trace_image_fused_grads_reference(scene, cam, cfg, SIZE, SIZE, 2.0,
                                                                                 RAND_VEC2, bn, lane_counts=lanes)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        fwd = megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        composed = megakernel.compose_deferred(got, deferred, scene, cfg).color
        torch.cuda.synchronize()
        stats = compare(got, ref)
        plane_err = max((sg - sg_ref).abs().max().item(), (deferred - deferred_ref).abs().max().item()
                        if deferred.numel() else 0.0)
        color_abs = (composed - fwd.color).abs().max().item()
        color_rel = ((composed - fwd.color).abs() / fwd.color.abs().clamp_min(1e-6)).max().item()
        others_equal = all(torch.equal(a, b) for a, b in zip(tuple(got)[1:], tuple(fwd)[1:]))
        layout = megakernel.deferred_layout(cfg, scene.mesh.albedo is not None or scene.mesh.normal_map is not None)
        reached = {}
        if "mw" in layout:
            reached["env-terminated lanes"] = int((deferred[0:3].amax(0) > 0).sum())
        if "emw" in layout:
            first = layout["emw"][0]
            reached["emissive-terminated lanes"] = int((deferred[first:first + 3].amax(0) > 0).sum())
            first = layout["albedo_uv"][0]
            reached["albedo factors per bounce"] = [int((deferred[first + 2 * b] > -1e5).sum()) for b in range(BOUNCES)]
        textured_cfg = "emw" in layout
        ok = (stats["ok"] and plane_err == 0.0 and tuple(sg.shape) == tuple(sg_ref.shape) and others_equal
              and (color_abs <= 1e-6 + 1e-5 * fwd.color.abs().max().item() if textured_cfg else color_abs == 0.0))
        counted = all(v > 0 for v in reached.values() if isinstance(v, int)) and all(
            min(v) > 0 for v in reached.values() if isinstance(v, list))
        phase("grad-parity-mesh", f"{key}: sg {tuple(sg.shape)}, deferred {tuple(deferred.shape)}, planes vs plain "
                                  f"max_abs_err {plane_err}, 11 planes " + json.dumps(stats) + f"; composed color vs "
                                  f"the forward kernel's max abs {color_abs:.3e}, max rel {color_rel:.3e}; {reached}; "
                                  f"plain grads {plain_ms:.1f} ms")
        if not ok or not counted:
            raise AssertionError(f"the grads kernel disagrees or a branch did not fire ({key})")
        grads_info[key] = dict(scene=scene, cam=cam, cfg=cfg, lanes=lanes, sg=sg_ref, deferred=deferred_ref,
                               plain_ms=plain_ms, err=max(stats["max_abs_err"], plane_err))

    grads_info.pop("textured_sky")  # held to its plain version only: the trainings and timings below leave it out

    # ---- 26. the fused gradient on a textured HDRI scene at 256² ---------------------
    gscene, gcam, gcfg = hdri_tex, raised, grads_info["textured_hdri_sun"]["cfg"]
    wvec = torch.tensor([1.0, 2.0, 3.0], device=dev, dtype=torch.float64)
    probe = megakernel.trace_image_fused(gscene, gcam, gcfg, GRAD_SIZE, GRAD_SIZE, 2.0, RAND_VEC2, bn)
    n_s = gscene.spheres.color.shape[0]
    qi = int(np.argmax([int((probe.object_id == n_s + q).sum()) for q in range(gscene.quads.v0.shape[0])]))

    def build(qc, exposure, albedo, emissive):
        colors = torch.cat([gscene.quads.color[:qi], qc[None], gscene.quads.color[qi + 1:]])
        return gscene._replace(quads=gscene.quads._replace(color=colors),
                               env=gscene.env._replace(hdr_exposure=exposure),
                               mesh=gscene.mesh._replace(albedo=albedo, emissive=emissive))

    def grad_loss(leaves, trace, **kw):
        out = trace(build(*leaves), gcam, gcfg, GRAD_SIZE, GRAD_SIZE, 2.0, RAND_VEC2, bn, **kw)
        return (out.color.double() * wvec).mean()

    base = [gscene.quads.color[qi].clone(), gscene.env.hdr_exposure.clone(), gscene.mesh.albedo, gscene.mesh.emissive]
    grads = {}
    for route, trace, kw in (("fused", megakernel.trace_image_fused, dict(differentiable=True)),
                             ("plain", megakernel.trace_image_fused_reference, {})):
        leaves = [x.clone().requires_grad_(True) for x in base]
        grads[route] = [g.detach() for g in torch.autograd.grad(grad_loss(leaves, trace, **kw), leaves)]
    picks = [("quad %d color" % qi, 0, int(grads["fused"][0].abs().argmax()), 1e-2),
             ("hdr_exposure", 1, 0, 1e-3)]
    for name, which, h in (("albedo", 2, 1e-2), ("emissive", 3, 1e-3)):
        top = torch.topk(grads["fused"][which].abs().reshape(-1), 8).indices.tolist()
        picks += [(f"{name} texel {np.unravel_index(i, tuple(base[which].shape))}", which, i, h) for i in top]
    rows, worst_plain, worst_fd = [], 0.0, 0.0
    for name, which, index, h in picks:
        g = grads["fused"][which].reshape(-1)[index].item()
        p = grads["plain"][which].reshape(-1)[index].item()
        vals = []
        with torch.no_grad():
            for step in (h, -h):
                leaves = [x.clone() for x in base]
                leaves[which].reshape(-1)[index] += step
                vals.append(grad_loss(leaves, megakernel.trace_image_fused).item())
        f = (vals[0] - vals[1]) / (2 * h)
        rel_plain, rel_fd = abs(g - p) / max(abs(p), 1e-12), abs(g - f) / max(abs(f), 1e-12)
        worst_plain, worst_fd = max(worst_plain, rel_plain), max(worst_fd, rel_fd)
        rows.append(f"{name} {g:.6e} (plain rel {rel_plain:.1e}, FD {f:.6e} rel {rel_fd:.1e})")
        if not (rel_plain <= 1e-4 and rel_fd <= 2e-2 and g != 0.0):
            raise AssertionError(f"the fused gradient of {name} disagrees: " + rows[-1])
    phase("grad-mesh", f"{GRAD_SIZE}x{GRAD_SIZE}, textured stand-in under the HDRI (sun NEE), raised camera, "
                       f"mean(color*[1,2,3]): " + "; ".join(rows) + f"; worst vs autograd {worst_plain:.2e}, vs "
                       f"central differences {worst_fd:.2e}")
    inv0 = tex.mesh.inv_matrix
    eye = torch.eye(4, device=dev)

    def moved(t):
        return tex._replace(mesh=tex.mesh._replace(
            inv_matrix=inv0 @ torch.cat([torch.cat([eye[:3, :3], -t.reshape(3, 1)], 1), eye[3:]])))

    tgrads = {}
    for plain in (False, True):
        t = torch.zeros(3, device=dev, requires_grad=True)
        out = trace_image(moved(t), raised, lobe_cfg, GRAD_SIZE, GRAD_SIZE, 2.0, RAND_VEC2, bn, plain_walk=plain)
        tgrads[plain] = torch.autograd.grad((out.color.double() * wvec).mean(), [t])[0]
    rel_t = ((tgrads[False] - tgrads[True]).abs() / tgrads[True].abs().clamp_min(1e-12)).max().item()
    phase("grad-mesh", f"mesh translation through the wavefront, kernel walk {tgrads[False].tolist()} vs plain walk "
                       f"{tgrads[True].tolist()}: max rel {rel_t:.2e}")
    if not (rel_t <= 1e-5 and tgrads[False].abs().min().item() > 0):
        raise AssertionError("the wavefront's translation gradient through the closest-hit kernel disagrees")

    # ---- 27. the inverse-rendering path: recover the stand-in's albedo --------------
    train = {}
    for route, fused, steps in (("fused", True, 10), ("wavefront", False, 3)):
        closest_hit.reset_launches()
        megakernel.reset_launches()
        t0 = time.perf_counter()
        out = recover_albedo(stand_in_model, bounces=BOUNCES, size=SIZE, steps=steps, lr=5e-2, tex_size=64,
                             fused=fused, camera=raised, device=dev, frames=TRAIN_FRAMES)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(closest_hit=closest_hit.LAUNCHES["closest_hit"], grads=megakernel.GRAD_LAUNCHES["textured"],
                        forward=megakernel.LAUNCHES["textured"], texel_grad=texel_grad.TEXEL_GRAD_LAUNCHES["shared"],
                        other=sum(megakernel.LAUNCHES.values()) + sum(megakernel.GRAD_LAUNCHES.values())
                        - megakernel.GRAD_LAUNCHES["textured"] - megakernel.LAUNCHES["textured"])
        losses = out["losses"]
        train[route] = launches
        phase("train-textured", f"{route} route, {SIZE}x{SIZE}, {BOUNCES} bounces, {steps} Adam steps on a 64x64 "
                                f"albedo in {train_s:.2f} s: loss {losses[0]:.6g} -> {losses[-1]:.6g}, albedo mean abs "
                                f"error {out['err0']:.4f} -> {out['err1']:.4f}; launches {launches}")
        want = (dict(closest_hit=0, grads=steps * len(TRAIN_FRAMES), forward=len(TRAIN_FRAMES),
                     texel_grad=steps * len(TRAIN_FRAMES) * BOUNCES, other=0) if fused
                else dict(closest_hit=(steps + 1) * len(TRAIN_FRAMES) * BOUNCES, grads=0, forward=0, texel_grad=0,
                          other=0))
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]) or launches != want:
            raise AssertionError(f"the {route} route did not lower the loss through its kernels ({launches})")
        if fused and not out["err1"] < out["err0"]:
            raise AssertionError("the fused route did not move the albedo toward the truth")
    # the other new grads configurations on the training path: 3 Adam steps each
    for key, param, truth, start in (("mesh", "quads", 1.0, 0.5), ("hdri_sun", "exposure", 1.0, 0.5),
                                     ("hdri_env", "exposure", 1.0, 0.5), ("sky_mesh", "quads", 1.0, 0.5),
                                     ("textured_hdri_sun", "albedo", None, 0.5),
                                     ("textured_hdri_env", "albedo", None, 0.5)):
        info = grads_info[key]
        tscene, tcam, tcfg = info["scene"], info["cam"], info["cfg"]

        def build_t(params, tscene=tscene, param=param):
            if param == "quads":  # every quad's color (the light's emission too) scaled by c
                return tscene._replace(quads=tscene.quads._replace(color=tscene.quads.color * params["c"])), tcam
            if param == "exposure":
                return tscene._replace(env=tscene.env._replace(hdr_exposure=params["c"])), tcam
            return tscene._replace(mesh=tscene.mesh._replace(albedo=params["c"])), tcam

        small = torch.as_tensor(np.ascontiguousarray(stand_in_model.albedo[::32, ::32]), device=dev)
        truth_t = small if truth is None else torch.tensor(truth, device=dev)
        init = torch.full_like(small, start) if truth is None else torch.tensor(start, device=dev)
        with torch.no_grad():
            target = render_avg(build_t({"c": truth_t})[0], tcam, tcfg, SIZE, TRAIN_FRAMES, RAND_VEC2, bn)
        megakernel.reset_launches()
        res = optimize(build_t, {"c": init}, target, tcfg, SIZE, steps=3, lr=0.05, frames=TRAIN_FRAMES)
        torch.cuda.synchronize()
        name = megakernel.configuration(tscene, tcfg)
        info["launches"] = megakernel.GRAD_LAUNCHES[name]
        losses = res.losses.cpu().numpy()
        phase("train-mesh", f"{key} ({param}): 3 Adam steps at {SIZE}x{SIZE}, loss {losses[0]:.6g} -> "
                            f"{losses[-1]:.6g}, grads launches {info['launches']}")
        if info["launches"] != 3 * len(TRAIN_FRAMES) or not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{key}: the training path did not run through the grads kernel or the loss rose")
    grads_info["textured"]["launches"] = train["fused"]["grads"]

    # ---- 28. timing ----------------------------------------------------------------------
    entries = []
    ch_rows = []
    ch_build = nvcc_report(closest_hit.KERNEL)
    for label, (case, mesh, ro, rd, act) in (("primary rays, glTF camera", cases[0]), ("bounce 2", cases[2])):
        ms, dev_ms = ch_timing[case]
        plain_ms = plain_times[case]
        flop, nbytes, steps, lengths = closest_hit_work(ro, rd, True, act, mesh)
        bound_ms, bound_by = bound(flop, nbytes)
        share = 100 * bound_ms / dev_ms if dev_ms else None
        ch_rows.append(dict(label=label, ms=ms, dev_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by))
        phase("timing-closest-hit", f"{card}: capacity mesh, {label}, {ro[..., 0].numel()} lanes: kernel device "
                                    f"{dev_ms} ms, through its wrapper {ms:.3f} ms, plain walk {plain_ms:.3f} ms; "
                                    f"inner-node visits / triangle tests {steps}; walks {json.dumps(lengths)}; "
                                    f"{flop / 1e9:.4f} GFLOP + "
                                    f"{nbytes / 1e6:.3f} MB -> "
                                    f"bound {bound_ms:.4f} ms ({bound_by}), "
                                    + (f"{share:.2f}% of it reached" if share else "not measured")
                                    + f"; nvcc: {json.dumps(ch_build)}")
    phase("timing-closest-hit", f"{card}: the wavefront pass at {SIZE}x{SIZE}, {BOUNCES} bounces, kernel walk / plain "
                                f"walk: " + "; ".join(f"{k} {a:.3f} / {b:.3f} ms" for k, (a, b) in wavefront.items()))
    entries.append({"name": "closest_hit", "route": "cuda", "source": "bpt_tpu_torch/csrc/closest_hit.cu",
                    "replaces": "bpt_tpu/kernels/traverse.py:181", "also_replaces": "bpt_tpu/kernels/traverse.py:444",
                    "launches": train["wavefront"]["closest_hit"], "max_abs_err": ch_err, "ms": ch_rows[0]["ms"],
                    "device_ms": ch_rows[0]["dev_ms"], "plain_ms": ch_rows[0]["plain_ms"],
                    "bound_ms": ch_rows[0]["bound_ms"], "bound_by": ch_rows[0]["bound_by"], "library_ms": None,
                    "bounce2_device_ms": ch_rows[1]["dev_ms"], "bounce2_bound_ms": ch_rows[1]["bound_ms"],
                    **ch_build})
    for key, info in grads_info.items():
        scene, cam, cfg, lanes = info["scene"], info["cam"], info["cfg"], info["lanes"]
        textured = key.startswith("textured")

        def call(scene=scene, cam=cam, cfg=cfg):
            return megakernel.trace_image_fused_grads(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)

        ms = event_ms(call, iters=10, warmup=2)
        dev_ms = kernel_device_ms(call, 10, instance(True, cfg.env, cfg.nee, True, textured))
        flop, nbytes = kernel_work(lanes, scene.quads.v0.shape[0], scene.spheres.color.shape[0], pixels,
                                   sky=cfg.env == "sky", mesh=True, hdri=scene.env if cfg.env == "hdri" else None,
                                   env_nee=cfg.nee == "env", textured=textured, deferred=True)
        n_obj = sum(0 if g is None else g.color.shape[0] for g in (scene.spheres, scene.quadrics, scene.quads))
        flop += info["sg"][:n_obj].sum().item() + 2 * (info["sg"][n_obj:] > 0).sum().item()
        nbytes += 4 * pixels * (info["sg"].shape[0] + info["deferred"].shape[0])
        bound_ms, bound_by = bound(flop, nbytes)
        share = 100 * bound_ms / dev_ms if dev_ms else None
        phase("timing-grads-mesh", f"{card}: {key} grads {SIZE}x{SIZE}, {BOUNCES} bounces: kernel device {dev_ms} ms, "
                                   f"through its wrapper {ms:.3f} ms, plain {info['plain_ms']:.1f} ms; "
                                   f"{flop / 1e9:.4f} GFLOP + {nbytes / 1e6:.3f} MB -> bound {bound_ms:.4f} ms "
                                   f"({bound_by}), " + (f"{share:.2f}% of it reached" if share else "not measured"))
        entries.append({"name": f"megakernel_{key}_grads", "route": "cuda",
                        "source": "bpt_tpu_torch/csrc/megakernel.cu",
                        "replaces": "bpt_tpu/kernels/megakernel.py:2180", "launches": info["launches"],
                        "max_abs_err": info["err"], "ms": ms, "device_ms": dev_ms, "plain_ms": info["plain_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    # the textured inverse-rendering cell: one fwd+bwd step (2 frames) of each route
    small = torch.as_tensor(np.ascontiguousarray(stand_in_model.albedo[::32, ::32]), device=dev)
    with torch.no_grad():
        target = render_avg(tex, raised, lobe_cfg, SIZE, TRAIN_FRAMES, RAND_VEC2, bn)
    step_rays = SIZE * SIZE * BOUNCES * len(TRAIN_FRAMES)
    for route, fused in (("fused", True), ("wavefront", False)):
        def step(fused=fused):
            albedo = torch.full_like(small, 0.5).requires_grad_(True)
            scene = tex._replace(mesh=tex.mesh._replace(albedo=albedo)).to(dev)
            img = render_avg(scene, raised, lobe_cfg, SIZE, TRAIN_FRAMES, RAND_VEC2, bn, fused=fused)
            torch.autograd.grad(((img - target) ** 2).mean(), [albedo])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = event_ms(step, iters=5 if fused else 2, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        host_ms, busy_ms, rows = profiled_step(step, iters=2 if fused else 1)
        top = "; ".join(f"{k[:50]} {t:.3f} ms x{n:g}" for k, t, n in rows[:6])
        phase("timing-inverse-rendering", f"{card}: textured stand-in, {SIZE}x{SIZE}, {BOUNCES} bounces, "
                                          f"{len(TRAIN_FRAMES)} frames, 64x64 albedo: {route} fwd+bwd step {ms:.3f} ms "
                                          f"({step_rays / ms / 1e3:.1f} Mrays/s), peak device memory {peak:.3f} GB; "
                                          f"under torch.profiler host {host_ms:.3f} ms, device busy {busy_ms:.3f} ms; "
                                          f"largest: {top}")
    # the texel VJP alone, on the albedo samples of one fused step
    samples, launch = [], texel_grad.texel_grad

    def keep(uv, g, shape):
        samples.append((uv.detach().clone(), g.detach().clone(), tuple(shape)))
        return launch(uv, g, shape)

    texel_grad.texel_grad = keep
    try:
        step(fused=True)
        torch.cuda.synchronize()
    finally:
        texel_grad.texel_grad = launch
    entries.append(texel_vjp_entry(card, samples, train["fused"]["texel_grad"]))
    return entries


def texel_vjp_entry(card: str, samples: list, launches: int) -> dict:
    """Phase 28's texel VJP: each (uv, cotangent, map shape) sample of a
    fused step through the kernel, held to ``texel_grad_reference`` within
    the order bound (n eps sum|terms| a texel: the same float32 terms added
    in another order, tests/test_torch_texel_grad.py), timed, and its bound
    by bytes: every lane's cotangent read, a live lane's UV, the map's
    gradient written.  Returns its entry of the kernels line (the worst
    sample's error, the mean of the times and bounds)."""
    from bpt_tpu_torch import textures
    from bpt_tpu_torch.kernels import texel_grad

    if len(samples) != BOUNCES * len(TRAIN_FRAMES):
        raise AssertionError(f"a fused step made {len(samples)} texel VJP launches, not {BOUNCES * len(TRAIN_FRAMES)}")
    rows, worst = [], 0.0
    for uv, g, shape in samples:
        h, w, c = shape
        got = texel_grad.texel_grad(uv, g, shape)
        want = texel_grad.texel_grad_reference(uv, g, shape)
        live = (g != 0).any(-1)
        terms = torch.zeros(h * w, device=g.device)
        x0i, x1i, y0i, y1i, _, _ = textures._coords(h, w, uv)
        for y in (y0i, y1i):
            for x in (x0i, x1i):
                idx = (y * w + x)[live]
                terms.index_add_(0, idx, torch.ones_like(idx, dtype=terms.dtype))
        order = terms.reshape(h, w, 1) * torch.finfo(torch.float32).eps * texel_grad.texel_grad_reference(
            uv, g.abs(), shape)
        err = (got - want).abs()
        n_live = int(live.sum())
        if not bool((err <= order).all()) or bool(got.any()) != (n_live > 0):
            raise AssertionError(f"the texel VJP is off its plain version by {float((err - order).max())} over the "
                                 f"order bound, or is 0 where {n_live} lanes are live, or not 0 where none is")
        worst = max(worst, float(err.max()))

        def kernel(uv=uv, g=g, shape=shape):
            return texel_grad.texel_grad(uv, g, shape)

        def plain(uv=uv, g=g, shape=shape):
            return texel_grad.texel_grad_reference(uv, g, shape)

        ms = event_ms(kernel, iters=20, warmup=2)
        plain_ms = event_ms(plain, iters=5, warmup=1)
        dev_ms = None
        for _ in range(3):  # a profiler session may record no device activity: run it again
            timed = [t for key, t, _ in profiled_step(kernel, 20)[2] if "texel_grad" in key]
            if timed:
                dev_ms = sum(timed)
                break
        nbytes = 4 * c * g[..., 0].numel() + 8 * n_live + 4 * h * w * c
        bound_ms, bound_by = bound(n_live * (8 + 12 * c), nbytes)
        rows.append(dict(ms=ms, dev_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         live=n_live, lanes=g[..., 0].numel(), bytes=nbytes))
    if not any(r["live"] for r in rows):
        raise AssertionError("no albedo sample of the fused step had a live lane")
    dev = [r["dev_ms"] for r in rows if r["dev_ms"] is not None]
    mean = {k: sum(r[k] for r in rows) / len(rows) for k in ("ms", "plain_ms", "bound_ms")}
    dev_ms = sum(dev) / len(dev) if dev else None
    share = 100 * mean["bound_ms"] / dev_ms if dev_ms else None
    phase("timing-texel-vjp", f"{card}: {len(rows)} albedo samples of a fused step, map {samples[0][2]}, "
                              f"{rows[0]['lanes']} lanes each, live {[r['live'] for r in rows]}: kernel device "
                              f"{[None if r['dev_ms'] is None else round(r['dev_ms'], 5) for r in rows]} ms, through "
                              f"its wrapper {mean['ms']:.4f} ms, plain route (four index_add_) {mean['plain_ms']:.4f} "
                              f"ms; max abs err {worst:.3e} (within the order bound); bytes "
                              f"{[r['bytes'] for r in rows]} -> bound {mean['bound_ms']:.5f} ms ({rows[0]['bound_by']}), "
                              + (f"{share:.2f}% of it reached" if share else "not measured"))
    return {"name": "texel_grad", "route": "cuda", "source": "bpt_tpu_torch/csrc/texel_grad.cu",
            "replaces": "none (the transpose of bpt_tpu/textures.py sample_bilinear's gather, left to XLA)",
            "launches": launches, "max_abs_err": worst, "ms": mean["ms"], "device_ms": dev_ms,
            "plain_ms": mean["plain_ms"], "bound_ms": mean["bound_ms"], "bound_by": rows[0]["bound_by"],
            "library_ms": None, **nvcc_report(texel_grad.KERNEL)}


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


def boundary_states(scene, cam, cfg, frames, rvs, bn: torch.Tensor, grads: bool = False) -> list:
    """(state, K2's boxes) of the staged pool of ``frames`` at SIZE² at each
    phase boundary (one phase per bounce), each phase launched from the last
    state sorted by the key kernel: what ``trace_staged`` hands each key."""
    from bpt_tpu_torch.kernels import megakernel, staged

    pool = staged.make_pool(SIZE, SIZE, frames, rvs, bn.device)
    outputs = megakernel.empty_outputs(scene, cfg, (len(frames), SIZE, SIZE), grads, bn.device)
    out, state, perm, boxes = [], None, None, None
    for lo in range(cfg.bounces):
        if lo > 0:
            out.append((state, boxes))
            perm = torch.sort(staged.launch_key(state, boxes=boxes)[0], stable=True).indices
        boxes = None if lo + 1 >= cfg.bounces else staged.phase_boxes(pool, lo, bn.device)
        state = staged.launch_phase(scene, cam, cfg, pool, bn, state, perm, lo, lo + 1, outputs, boxes)
    return out


def key_device_ms(fn, iters: int = 10, tries: int = 3) -> list | None:
    """[pass 1, pass 2]: the key kernel's mean device ms per launch of each
    pass while ``fn`` runs, by the profiler (a mean per launch, not per
    call: a profile may miss some launches); None when no profile recorded
    both."""
    for _ in range(tries):
        rows = profiled_step(fn, iters)[2]
        means = []
        for name in ("key_box_kernel", "key_kernel"):  # the second is not a substring of the first
            hit = [(ms, n) for key, ms, n in rows if name in key]
            if hit:
                means.append(sum(ms for ms, _ in hit) / sum(n for _, n in hit))
        if len(means) == 2:
            return means
    return None


def key_work(state) -> tuple[float, float]:
    """(FP32 operations, bytes) of the sort key of one boundary's state: the
    flags word of every lane read and its key written (8 bytes), a live
    lane's ro and rd read (24 more); per live lane the origin's three cells
    (a subtraction, a division and a product each: 9).  What the function
    must move; the kernel reads each row's first 32 bytes twice."""
    from bpt_tpu_torch.kernels import staged

    live = int(((state[:, staged.FLAGS_WORD] & 1) != 0).sum().item())
    return 9.0 * live, 8.0 * state.shape[0] + 24.0 * live


def staged_path(card: str, bn: torch.Tensor, capacity, stand_in) -> list:
    """Phases 29-33: the staged multi-frame path (K2, csrc/staged.cu).
    ``capacity`` and ``stand_in`` are the capacity mesh and the textured
    stand-in's mesh (host tensors).  Returns K2's entries of the kernels
    line."""
    from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.diff.inverse import optimize, render_avg
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import megakernel, staged
    from bpt_tpu_torch.kernels.integration import attach_cuda_path
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu_torch.scenes.gltf_scene import (gltf_camera, gltf_scene, hdri_camera, hdri_scene,
                                                 heightfield_model, mesh_from_model)
    from bpt_tpu_torch.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene
    from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene, sky_camera
    from bpt_tpu_torch.scenes.types import DIFFUSE, METAL, TRANSPARENT

    dev = torch.device("cuda")
    raised = Camera.look(position=(0.0, 10.0, -70.0), pitch=0.5, fov=0.8, focus_distance=113.0).to(dev)
    cfg4 = IntegratorConfig(bounces=BOUNCES)
    hdri_base = dict(bounces=BOUNCES, env="hdri", diffuse_indirect_max=2)
    sun = dict(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03)
    lobe_cfg = IntegratorConfig(bounces=BOUNCES, metal_roughness_lobe=True)
    mesh_scene, tex_scene = gltf_scene(capacity, device=dev), gltf_scene(stand_in, device=dev)
    configs = {  # every K1 configuration: (scene, camera, cfg)
        "cornell_metal": (cornell_scene(right_sphere_mat=METAL, device=dev), cornell_camera(device=dev), cfg4),
        "cornell_transparent": (cornell_scene(right_sphere_mat=TRANSPARENT, device=dev), cornell_camera(device=dev),
                                cfg4),
        "quadric": (quadric_geometry_scene(device=dev), quadric_camera(device=dev),
                    IntegratorConfig(bounces=BOUNCES, transparent_tint=True)),
        "sky": (physical_sky_scene(device=dev), sky_camera(device=dev),
                IntegratorConfig(bounces=BOUNCES, env="sky", nee="sun")),
        "mesh": (mesh_scene, gltf_camera(device=dev), cfg4),
        "hdri_sun": (hdri_scene(capacity, synthetic_hdr(sun_uv=(0.7, 0.7)), device=dev), hdri_camera(device=dev),
                     IntegratorConfig(**sun, **hdri_base)),
        "hdri_env": (hdri_scene(capacity, synthetic_hdr(), device=dev), hdri_camera(device=dev),
                     IntegratorConfig(nee="env", **hdri_base)),
        "textured": (tex_scene, raised, lobe_cfg),
        "textured_hdri_sun": (hdri_scene(stand_in, synthetic_hdr(sun_uv=(0.7, 0.7)), device=dev), raised,
                              IntegratorConfig(**sun, **hdri_base, metal_roughness_lobe=True)),
        "textured_hdri_env": (hdri_scene(stand_in, synthetic_hdr(sun_uv=(0.7, 0.7)), device=dev), raised,
                              IntegratorConfig(nee="env", **hdri_base, metal_roughness_lobe=True)),
        "textured_sky": (physical_sky_scene(device=dev)._replace(mesh=tex_scene.mesh), raised,
                         IntegratorConfig(bounces=BOUNCES, env="sky", nee="sun", metal_roughness_lobe=True)),
    }
    frames, rvs = (2.0, 3.0), (RAND_VEC2, np.array([0.6, 0.1], np.float32))
    lanes2 = 2 * SIZE * SIZE

    # ---- 29. parity-staged: F = 2 pools against K1, frame by frame -------------------------
    staged_err = key_err = 0.0
    for key, (scene, cam, cfg) in configs.items():
        name = megakernel.configuration(scene, cfg)
        errs = []
        for grads in (False, True):
            counts = megakernel.STAGED_GRAD_LAUNCHES if grads else megakernel.STAGED_LAUNCHES
            before = counts[name]
            pool, sg, deferred = staged.trace_staged(scene, cam, cfg, SIZE, SIZE, frames, rvs, bn, grads=grads)
            if counts[name] != before + cfg.bounces:
                raise AssertionError(f"{key}: {counts[name] - before} staged launches for {cfg.bounces} phases")
            for i, (frame, rv) in enumerate(zip(frames, rvs)):
                if grads:
                    one, sg1, def1 = megakernel.trace_image_fused_grads(scene, cam, cfg, SIZE, SIZE, frame, rv, bn)
                    pairs = list(zip((t[i] for t in pool), one)) + [(sg[:, i], sg1), (deferred[:, i], def1)]
                else:
                    pairs = list(zip((t[i] for t in pool),
                                     megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, frame, rv, bn)))
                torch.cuda.synchronize()
                errs.append(max((a - b).abs().max().item() if a.numel() else 0.0 for a, b in pairs))
                if not all(torch.equal(a, b) for a, b in pairs):
                    raise AssertionError(f"{key}: the staged pool's frame {frame} (grads {grads}) differs from K1's: "
                                         f"max abs err {errs[-1]}")
        # the same pool phase by phase: the key kernel against sort_key at each boundary, in every mode
        live, moved = [], 0.0
        for b, (state, boxes) in enumerate(boundary_states(scene, cam, cfg, frames, rvs, bn)):
            for mode in staged.KEY_MODES:
                got_key = staged.launch_key(state, mode, boxes)[0]
                rows_key = staged.launch_key(state, mode)[0]
                plain_key = staged.sort_key(state, mode)
                perm = torch.sort(got_key, stable=True).indices
                key_err = max(key_err, (got_key - plain_key).abs().max().item(),
                              (rows_key - plain_key).abs().max().item())
                if not (torch.equal(got_key, plain_key) and torch.equal(rows_key, plain_key)
                        and torch.equal(perm, torch.sort(plain_key, stable=True).indices)):
                    raise AssertionError(f"{key}: the key kernel ({mode}) differs from sort_key at boundary {b + 1}")
                if b == 0 and mode == "oct-morton":
                    moved = (perm != torch.arange(lanes2, device=dev)).float().mean().item()
            live.append(int(((state[:, staged.FLAGS_WORD] & 1) != 0).sum().item()))
        lanes = []  # the branches, counted by the plain pool at 64²
        staged.trace_staged(scene, cam, cfg, 64, 64, frames, rvs, bn, lane_counts=lanes)
        hits, misses = sum(int(c.hits) for c in lanes), sum(int(c.misses) for c in lanes)
        fired = {"hits": hits > 0}
        if cfg.env != "none":
            fired["misses"] = misses > 0
        if scene.quadrics is not None:
            fired["torus steps"] = sum(int(c.torus_steps) for c in lanes) > 0
        if scene.mesh is not None:
            fired["node visits"] = sum(int(c.node_visits) for c in lanes) > 0
        if key == "hdri_sun":
            fired["shadow rays reaching the sky"] = sum(int(c.shadow_misses) for c in lanes) > 0
        if name == "textured":
            samples = sum(c.texel_samples for c in lanes).tolist()
            fired["albedo, normal and metallic-roughness samples"] = min(samples[:3]) > 0
            fired["emissive terminations"] = sum(int(c.emissive_hits) for c in lanes) > 0
            fired["lobe draws"] = sum(int(c.lobe_draws) for c in lanes) > 0
        staged_err = max(staged_err, *errs)
        phase("parity-staged", f"{key}: F=2 pool at {SIZE}x{SIZE}, frames 2 and 3, forward and grads bit-equal to K1 "
                               f"frame by frame (11 planes, sg, deferred), {cfg.bounces} launches each; live lanes at "
                               f"the boundaries {live} of {lanes2}, the key kernel (from K2's boxes and from the "
                               f"rows) bit-equal to sort_key there in "
                               f"{', '.join(staged.KEY_MODES)} (the same permutations), the first sort moved "
                               f"{100 * moved:.1f}% of the lanes; "
                               "plain 64x64 pool: " + ", ".join(f"{k} {'yes' if v else 'NO'}"
                                                                for k, v in fired.items()))
        if not (all(fired.values()) and moved > 0.0):
            raise AssertionError(f"{key}: a branch did not fire or the sort moved no lane")

    # one phase at a time against the plain phase, from the same state, at 256²
    for key in ("cornell_transparent", "textured"):
        scene, cam, cfg = configs[key]
        pool_def = staged.make_pool(GRAD_SIZE, GRAD_SIZE, frames, rvs, dev)
        for grads in (False, True):
            outputs = megakernel.empty_outputs(scene, cfg, (2, GRAD_SIZE, GRAD_SIZE), grads, dev)
            state, perm, rows = None, None, []
            for lo in range(cfg.bounces):
                plain = {k: None if v is None else v.clone() for k, v in outputs.items()}
                if lo > 0:
                    perm = torch.sort(staged.launch_key(state)[0], stable=True).indices
                got = staged.launch_phase(scene, cam, cfg, pool_def, bn, state, perm, lo, lo + 1, outputs)
                ref = staged.trace_phase_reference(scene, cam, cfg, pool_def, bn, state, perm, lo, lo + 1, plain)
                torch.cuda.synchronize()
                ok = all(torch.allclose(outputs[k], plain[k], rtol=0, atol=0, equal_nan=True)  # unwritten: the same
                         for k in outputs if outputs[k] is not None)
                if got is not None:
                    flags = staged.FLAGS_WORD
                    live = (ref[:, flags] & 1) != 0
                    ok = ok and torch.equal(got[:, flags], ref[:, flags]) and torch.equal(got[live], ref[live])
                    rows.append(int(live.sum().item()))
                if not ok:
                    raise AssertionError(f"{key}: staged phase [{lo}, {lo + 1}) (grads {grads}) differs from the "
                                         "plain phase")
                state = got
            phase("parity-staged", f"{key} at {GRAD_SIZE}x{GRAD_SIZE}, grads {grads}: each of the {cfg.bounces} "
                                   f"phases bit-equal to trace_phase_reference from the same sorted state (state "
                                   f"rows of the live lanes {rows}, every dead lane's flags, every output plane)")

    # ---- 30. grad-parity-staged: the staged VJP at 256² -----------------------------------
    wvec = torch.tensor([1.0, 2.0, 3.0], device=dev, dtype=torch.float64)
    cscene, ccam, _ = configs["cornell_transparent"]
    tscene, tcam, tcfg = configs["textured"]

    def cornell_build(lc):
        return cscene._replace(quads=cscene.quads._replace(color=torch.cat([cscene.quads.color[:5], lc[None]])))

    def textured_build(albedo, sc):
        spheres = tscene.spheres._replace(color=torch.cat([sc[None], tscene.spheres.color[1:]]))
        return tscene._replace(mesh=tscene.mesh._replace(albedo=albedo), spheres=spheres)

    problems = {"cornell (light color)": (cornell_build, ccam, cfg4, [torch.tensor([10.0, 10.0, 10.0], device=dev)],
                                          [(0, 1e-2)]),
                "textured stand-in (albedo map, sphere 0 color)": (
                    textured_build, tcam, tcfg, [tscene.mesh.albedo, torch.tensor([0.9, 0.9, 0.9], device=dev)],
                    [(0, 1e-2), (1, 1e-2)])}
    for label, (build_fn, cam, cfg, base, probes) in problems.items():
        def loss(leaves, reorder, build_fn=build_fn, cam=cam, cfg=cfg):
            img = render_avg(build_fn(*leaves), cam, cfg, GRAD_SIZE, frames, RAND_VEC2, bn, reorder=reorder)
            return (img.double() * wvec).mean()

        grads = {}
        for reorder in (False, True):
            leaves = [x.clone().requires_grad_(True) for x in base]
            grads[reorder] = [g.detach() for g in torch.autograd.grad(loss(leaves, reorder), leaves)]
        rows, worst_mono, worst_fd = [], 0.0, 0.0
        for which, h in probes:
            flat = grads[True][which].reshape(-1)
            picks = torch.topk(flat.abs(), min(8, flat.numel())).indices.tolist() if flat.numel() > 3 else \
                [int(flat.abs().argmax())]
            for index in picks:
                g, m = flat[index].item(), grads[False][which].reshape(-1)[index].item()
                vals = []
                with torch.no_grad():
                    for step in (h, -h):
                        leaves = [x.clone() for x in base]
                        leaves[which].reshape(-1)[index] += step
                        vals.append(loss(leaves, True).item())
                f = (vals[0] - vals[1]) / (2 * h)
                rel_mono, rel_fd = abs(g - m) / max(abs(m), 1e-12), abs(g - f) / max(abs(f), 1e-12)
                worst_mono, worst_fd = max(worst_mono, rel_mono), max(worst_fd, rel_fd)
                rows.append(f"leaf {which}[{index}] {g:.6e}")
                if not (rel_mono <= 1e-4 and rel_fd <= 2e-2 and g != 0.0):
                    raise AssertionError(f"the staged VJP of {label} disagrees at leaf {which}[{index}]: {g} vs "
                                         f"monolithic {m}, central difference {f}")
        phase("grad-parity-staged", f"{GRAD_SIZE}x{GRAD_SIZE}, frames 2 and 3 as one pool, {label}, "
                                    f"mean(color*[1,2,3]): {len(rows)} probes ({'; '.join(rows[:3])}; ...), worst vs "
                                    f"the monolithic VJP {worst_mono:.2e}, vs central differences {worst_fd:.2e}")

    # ---- 31. main-staged: the batched renderer through the staged pool ---------------------
    main_launches, main_keys = {}, 0
    for key, scene_fn, camera in (("cornell", lambda: cornell_scene(), cornell_camera()),
                                  ("mesh", lambda: gltf_scene(capacity), gltf_camera())):
        attached, plain_r = (ProgressiveRenderer(scene_fn(), cfg4, SIZE, SIZE, seed=7) for _ in range(2))
        attach_cuda_path(attached, reorder=True)
        megakernel.reset_launches()
        img = attached.render(camera, spp=SPP, batch=4)
        torch.cuda.synchronize()
        n_staged, n_k1 = sum(megakernel.STAGED_LAUNCHES.values()), sum(megakernel.LAUNCHES.values())
        n_keys = sum(staged.KEY_LAUNCHES.values())
        main_keys += n_keys
        ref = plain_r.render(camera, spp=SPP)
        torch.cuda.synchronize()
        equal = torch.equal(attached.state.accum, plain_r.state.accum) and torch.equal(img, ref)
        main_launches[key] = n_staged
        phase("main-staged", f"{key} {SIZE}x{SIZE}, render(spp={SPP}, batch=4) through attach_cuda_path(reorder=True):"
                             f" {n_staged} staged launches ({BOUNCES} phases x 2 pools), {n_keys} key launches, "
                             f"{n_k1} K1 launch (the first sample); accum bit-equal to sample-at-a-time stepping: "
                             f"{equal}; display in [{img.min().item():.4f}, {img.max().item():.4f}]")
        if not (equal and n_staged == BOUNCES * 2 and n_keys == (BOUNCES - 1) * 2 and n_k1 == 1
                and bool(torch.isfinite(img).all())):
            raise AssertionError(f"{key}: the batched staged render differs or did not go through K2")
        attach_cuda_path(attached)
        if attached.batch_step is not None:
            raise AssertionError("attach_cuda_path(reorder=False) left the staged batch step installed")

    # ---- 32. train-staged: optimize(reorder=True) on the Cornell emission problem ------------
    tbase = cornell_scene(device=dev)
    tcam2 = cornell_camera(device=dev)

    def build_scene(params):
        color = torch.cat([tbase.quads.color[:5], (params["emission"] * torch.ones(3, device=dev))[None]])
        return tbase._replace(quads=tbase.quads._replace(color=color)), tcam2

    target = render_avg(build_scene({"emission": torch.tensor(10.0, device=dev)})[0], tcam2, cfg4, SIZE,
                        TRAIN_FRAMES, RAND_VEC2, bn)
    megakernel.reset_launches()
    t0 = time.perf_counter()
    result = optimize(build_scene, {"emission": 4.0}, target, cfg4, SIZE, steps=TRAIN_STEPS, lr=0.5,
                      frames=TRAIN_FRAMES, reorder=True)
    losses = result.losses.cpu().numpy()
    train_s = time.perf_counter() - t0
    train_launches = megakernel.STAGED_GRAD_LAUNCHES["cornell"]
    train_keys = sum(staged.KEY_LAUNCHES.values())
    emission = float(result.params["emission"])
    phase("train-staged", f"{SIZE}x{SIZE}, {BOUNCES} bounces, {TRAIN_STEPS} steps of optimize(reorder=True) in "
                          f"{train_s:.3f} s: loss {losses[0]:.6g} -> {losses[-1]:.6g}, emission 4.0 -> {emission:.5f} "
                          f"(truth 10.0); staged grads launches {train_launches}, key launches {train_keys}")
    if not (losses[-1] < 0.05 * losses[0] and np.isfinite(losses).all() and train_launches == TRAIN_STEPS * BOUNCES
            and train_keys == TRAIN_STEPS * (BOUNCES - 1) and sum(megakernel.GRAD_LAUNCHES.values()) == 0):
        raise AssertionError("optimize(reorder=True) did not lower the loss below 5% of its start through K2")

    # ---- 33. timing-staged: 8 frames in one pool against 8 K1 launches ----------------------
    fcs = [2.0 + i for i in range(BENCH_FRAMES)]
    rng = np.random.default_rng(11)
    rv8 = [rng.random(2).astype(np.float32) for _ in fcs]
    lanes8 = BENCH_FRAMES * SIZE * SIZE
    rays8 = lanes8 * BOUNCES
    rugged = mesh_from_model(heightfield_model(rugged=True), mat_type=DIFFUSE, use_native="require")
    cells = {"cornell": (configs["cornell_transparent"][0], cornell_camera(device=dev), cfg4),
             "mesh": (mesh_scene, gltf_camera(device=dev), cfg4),
             "mesh_rugged": (gltf_scene(rugged, device=dev), gltf_camera(device=dev), cfg4),
             "textured": configs["textured"]}
    timed = {}
    for key, (scene, cam, ccfg) in cells.items():
        has_mesh = scene.mesh is not None
        textured = megakernel.configuration(scene, ccfg) == "textured"
        grads_modes = (False, True) if key in ("cornell", "textured") else (False,)
        for grads in grads_modes:
            def pool(record=None, scene=scene, cam=cam, ccfg=ccfg, grads=grads):
                return staged.trace_staged(scene, cam, ccfg, SIZE, SIZE, fcs, rv8, bn, record=record, grads=grads)

            def mono(scene=scene, cam=cam, ccfg=ccfg, grads=grads):
                trace = megakernel.trace_image_fused_grads if grads else megakernel.trace_image_fused
                return [trace(scene, cam, ccfg, SIZE, SIZE, f, rv, bn) for f, rv in zip(fcs, rv8)]

            pool_ms, mono_ms = event_ms(pool, iters=3, warmup=1), event_ms(mono, iters=3, warmup=1)
            pool_ms2, mono_ms2 = event_ms(pool, iters=3, warmup=0), event_ms(mono, iters=3, warmup=0)
            sums = {}
            for _ in range(3):
                rec = []
                pool(rec)
                torch.cuda.synchronize()
                for (_, a), (label, b) in zip(rec, rec[1:]):
                    sums[label] = sums.get(label, 0.0) + a.elapsed_time(b) / 3
            phase_ms = [sums[f"phase {b}"] for b in range(BOUNCES)]
            key_ms = [sums[f"key {b}"] for b in range(1, BOUNCES)]
            sort_ms = [sums[f"sort {b}"] for b in range(1, BOUNCES)]
            kt = {"device": [], "events": [], "rows": [], "plain": [], "bound": [], "live": []}  # per boundary
            for state, boxes in boundary_states(scene, cam, ccfg, fcs, rv8, bn, grads=grads):
                kt["events"].append(event_ms(lambda state=state, boxes=boxes: staged.launch_key(state, boxes=boxes),
                                            iters=20, warmup=2))
                kt["device"].append(key_device_ms(lambda state=state, boxes=boxes: staged.launch_key(state,
                                                                                                      boxes=boxes)))
                kt["rows"].append(key_device_ms(lambda state=state: staged.launch_key(state)))
                kt["plain"].append(event_ms(lambda state=state: staged.sort_key(state), iters=5, warmup=1))
                kt["bound"].append(bound(*key_work(state))[0])
                kt["live"].append(int(((state[:, staged.FLAGS_WORD] & 1) != 0).sum().item()))
            key_dev = [sum(d) if d is not None else e for d, e in zip(kt["device"], kt["events"])]
            dev_k2 = kernel_device_ms(pool, 2, instance(grads, "none", "quad", has_mesh, textured, "phase_kernel"))
            dev_k1 = kernel_device_ms(mono, 2, instance(grads, "none", "quad", has_mesh, textured))
            lanes = []
            scale = BENCH_FRAMES if has_mesh else 1  # the plain walk takes seconds a frame: frame 2's counts, x 8
            t0 = time.perf_counter()
            plain_out = staged.trace_staged(scene, cam, ccfg, SIZE, SIZE, fcs[:BENCH_FRAMES // scale],
                                            rv8[:BENCH_FRAMES // scale], bn, lane_counts=lanes,
                                            grads=grads)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            n_q, n_s = scene.quads.v0.shape[0], 0 if scene.spheres is None else scene.spheres.color.shape[0]
            flop, nbytes = staged_work(lanes, BENCH_FRAMES, lanes8, scale, n_quads=n_q, n_spheres=n_s, mesh=has_mesh,
                                       textured=textured, deferred=grads)
            if grads:  # the sg and deferred planes: one add per counted hit, each plane written once
                sg, n_obj = plain_out[1], n_q + n_s
                flop += scale * (sg[:n_obj].sum().item() + 2 * (sg[n_obj:] > 0).sum().item())
                nbytes += 4 * lanes8 * (sg.shape[0] + plain_out[2].shape[0])
            bound_ms, bound_by = bound(flop, nbytes)
            k2_ms = sum(phase_ms)
            dev_pool = None if dev_k2 is None else dev_k2 * BOUNCES
            share = 100 * bound_ms / dev_pool if dev_pool else None
            live = [int(c.live) * scale for c in lanes]
            label = key + (" grads" if grads else "")
            phase("timing-staged", f"{card}: {label} {SIZE}x{SIZE}, {BOUNCES} bounces, {BENCH_FRAMES} frames in one "
                                   f"pool ({lanes8} lanes): pool {pool_ms:.3f} / {pool_ms2:.3f} ms "
                                   f"({rays8 / pool_ms / 1e3:.1f} Mrays/s) against {BENCH_FRAMES} K1 launches "
                                   f"{mono_ms:.3f} / {mono_ms2:.3f} ms ({rays8 / mono_ms / 1e3:.1f} Mrays/s); phases "
                                   f"(CUDA events) {[round(x, 4) for x in phase_ms]} ms, sum {k2_ms:.4f}; sort keys "
                                   f"{[round(x, 4) for x in key_ms]} ms, torch.sort {[round(x, 4) for x in sort_ms]} "
                                   f"ms; K2 device {dev_pool} ms per pool (profiler), K1 device {dev_k1} ms per "
                                   f"frame; live lanes per bounce {live}{' (frame 2 x 8)' if scale > 1 else ''}; "
                                   f"{flop / 1e9:.4f} GFLOP + {nbytes / 1e6:.3f} MB -> bound {bound_ms:.4f} ms "
                                   f"({bound_by}), " + (f"{share:.2f}% of it reached" if share else "not measured")
                                   + f"; plain pool of {BENCH_FRAMES // scale} frame(s) {plain_ms:.1f} ms")
            shares = [round(100 * b / d, 1) for b, d in zip(kt["bound"], key_dev)]
            phase("timing-staged", f"{card}: {label}, the key kernel on each boundary's state ({lanes8} lanes, live "
                                   f"{kt['live']}): device [pass 1 over K2's boxes, pass 2] {kt['device']} ms "
                                   f"(profiler; from the rows {kt['rows']}), through its wrapper "
                                   f"{[round(x, 4) for x in kt['events']]} ms; bound "
                                   f"{[round(x, 4) for x in kt['bound']]} ms (bytes), {shares}% of it reached; the "
                                   f"torch sort_key {[round(x, 4) for x in kt['plain']]} ms")
            timed[label] = dict(ms=k2_ms, device_ms=dev_pool, pool_ms=pool_ms, k1_frames_ms=mono_ms,
                                key_ms=sum(key_ms), sort_ms=sum(sort_ms), plain_ms=plain_ms,
                                plain_frames=BENCH_FRAMES // scale, bound_ms=bound_ms, bound_by=bound_by,
                                key_kernel_ms=key_dev, key_plain_ms=kt["plain"], key_bound_ms=kt["bound"])
    common = {"route": "cuda", "source": "bpt_tpu_torch/csrc/staged.cu",
              "replaces": "bpt_tpu/kernels/megakernel.py:2619",
              "max_abs_err": staged_err, "library_ms": None}
    entries = [dict(name="staged_cornell", launches=main_launches["cornell"], **common, **timed["cornell"]),
               dict(name="staged_cornell_grads", launches=train_launches, **common, **timed["cornell grads"]),
               dict(name="staged_mesh", launches=main_launches["mesh"], **common, **timed["mesh"],
                    **{f"rugged_{k}": v for k, v in timed["mesh_rugged"].items()},
                    **{f"textured_{k}": v for k, v in timed["textured"].items()},
                    **{f"textured_grads_{k}": v for k, v in timed["textured grads"].items()})]
    mesh_key = timed["mesh"]  # the 8-frame capacity pool: per key, the mean of its three boundaries
    entries.append(dict(name="staged_key", route="cuda", source="bpt_tpu_torch/csrc/sort_key.cu",
                        replaces="bpt_tpu/kernels/megakernel.py:2631", launches=main_keys, max_abs_err=key_err,
                        ms=float(np.mean(mesh_key["key_kernel_ms"])), plain_ms=float(np.mean(mesh_key["key_plain_ms"])),
                        bound_ms=float(np.mean(mesh_key["key_bound_ms"])), bound_by="bytes", library_ms=None,
                        per_boundary={k: {f: v[f] for f in ("key_kernel_ms", "key_plain_ms", "key_bound_ms")}
                                      for k, v in timed.items()}))

    # the textured stand-in's fwd+bwd step w.r.t. its albedo map (bench.py --reorder --backward's shape)
    fwd_bwd = {}
    for reorder in (False, True):
        def step(reorder=reorder):
            albedo = tscene.mesh.albedo.clone().requires_grad_(True)
            scene = tscene._replace(mesh=tscene.mesh._replace(albedo=albedo))
            if reorder:
                out = megakernel.trace_frames_fused(scene, tcam, tcfg, SIZE, SIZE, fcs, [RAND_VEC2] * len(fcs), bn,
                                                    differentiable=True).color.sum(0)
            else:
                out = sum(megakernel.trace_image_fused(scene, tcam, tcfg, SIZE, SIZE, f, RAND_VEC2, bn,
                                                       differentiable=True).color for f in fcs)
            return torch.autograd.grad(out.mean(), [albedo])[0]

        torch.cuda.reset_peak_memory_stats()
        fwd_bwd[reorder] = (event_ms(step, iters=3, warmup=1), torch.cuda.max_memory_allocated() / 1e9, step())
    g_mono, g_staged = fwd_bwd[False][2], fwd_bwd[True][2]
    rel = ((g_staged - g_mono).abs().max() / g_mono.abs().max()).item()
    phase("timing-staged", f"{card}: textured stand-in fwd+bwd step w.r.t. its {tuple(tscene.mesh.albedo.shape)} "
                           f"albedo map, {SIZE}x{SIZE}, {BOUNCES} bounces, {BENCH_FRAMES} frames: staged pool "
                           f"{fwd_bwd[True][0]:.3f} ms ({rays8 / fwd_bwd[True][0] / 1e3:.1f} Mrays/s, peak "
                           f"{fwd_bwd[True][1]:.3f} GB) against {BENCH_FRAMES} K1 grads launches "
                           f"{fwd_bwd[False][0]:.3f} ms ({rays8 / fwd_bwd[False][0] / 1e3:.1f} Mrays/s, peak "
                           f"{fwd_bwd[False][1]:.3f} GB); the map gradients agree to {rel:.2e} of their largest")
    if not rel <= 1e-4:
        raise AssertionError("the staged fwd+bwd step's albedo gradient differs from the monolithic one")
    return entries


LOOP_PARITY_ITERS = 50  # the plain version launches some two dozen torch ops per step: keep it short
LOOP_RISE_ITERS = 4  # per placement of the one rising element (8 placements)
LOOP_CLOCK_ITERS, LOOP_CLOCK_LAUNCHES = 50_000, 20  # the load under which the SM clock is read
LOOP_ITERS = 4000  # the tool's default
LOOP_SASS_OPS = ("FFMA", "FMUL", "FMNMX", "LDS", "BAR", "VOTE", "BRA", "FSEL", "FSETP")


def loop_cost_sass(library) -> dict:
    """{(n_ops, reduce, cond): {opcode: count, "instructions": n,
    "backward_branches": n}} of each loop_cost_kernel instantiation in the
    built library, from cuobjdump -sass; {} where cuobjdump is missing."""
    import re
    from pathlib import Path

    from bpt_tpu_torch.kernels import build

    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out, current, labels = {}, None, set()
    for line in sass.splitlines():
        m = re.search(r"Function : \S*loop_cost_kernelILi(\d+)ELb([01])ELb([01])E", line)
        if m:
            current, labels = out.setdefault((int(m[1]), m[2] == "1", m[3] == "1"), {
                "instructions": 0, "backward_branches": 0, **dict.fromkeys(LOOP_SASS_OPS, 0)}), set()
            continue
        if "Function :" in line:
            current = None
        label = re.match(r"\s*(\.L\w+):", line)
        if label:
            labels.add(label[1])
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)(\.\S+)?\s*([^;]*);", line)
        if current is None or not m:
            continue
        op = m[2]
        current["instructions"] += 1
        if op in current:
            current[op] += 1
        if op == "BRA":  # to an address or a label above it: a loop (not the branch to itself after EXIT)
            target = re.search(r"0x([0-9a-f]+)", m[4])
            named = re.search(r"(\.L\w+)", m[4])
            if (target and int(target[1], 16) < int(m[1], 16)) or (named and named[1] in labels):
                current["backward_branches"] += 1
    return out


def loop_cost_rise_inputs(seed: int = 9) -> list:
    """[(label, tab, x)] of float32 numpy inputs for K5: a seeded table
    whose every entry lies in [0.997, 0.999], so that each step shrinks a
    positive value, and for each of the tile's 8 rows a positive seeded
    tile with one negative element in that row, the one element that rises.
    The any-reduce is then set by the block that holds that row alone,
    whatever the cluster's mapping (block b holds rows [b V, b V + V)): a
    block-local vote would scale that block's share alone."""
    from bpt_tpu_torch.kernels.loop_cost import TAB_SHAPE, TILE

    rng = np.random.default_rng(seed)
    tab = (0.998 + rng.uniform(-1e-3, 1e-3, TAB_SHAPE)).astype(np.float32)
    base = rng.uniform(0.5, 1.5, TILE).astype(np.float32)
    inputs = []
    for row in range(TILE[0]):
        x = base.copy()
        x[row, (37 * row + 11) % TILE[1]] = -1.0
        inputs.append((f"row {row} rises", tab, x))
    return inputs


def loop_cost_work(n_iter: int, n_ops: int, use_reduce: bool) -> tuple[float, float]:
    """(FP32 operations, bytes) of one launch: per element and iteration an
    FMA (2) and a multiply (1) per step, and with the reduce the multiply by
    0.9999 (1: counted in every iteration, as jnp.where computes it; under
    lax.cond it runs while the flag is set, so this overcounts by at most
    1 / (3 n_ops + 1)); max, compares and selects are left out.  Bytes: the
    32 KB table and the 8 KB tile read, the 8 KB tile written."""
    from bpt_tpu_torch.kernels.loop_cost import TAB_SHAPE, TILE

    elements = TILE[0] * TILE[1]
    return (float(n_iter) * elements * (3 * n_ops + int(use_reduce)),
            4.0 * (TAB_SHAPE[0] * TAB_SHAPE[1] + 2 * elements))


def loop_cost_path(card: str) -> list:
    """Phases 34-36: K5, the walk-loop cost microbenchmark (csrc/loop_cost.cu)
    and its tool.  Returns its entries of the kernels line."""
    import tempfile
    from pathlib import Path

    from bpt_tpu_torch.kernels import build
    from bpt_tpu_torch.kernels import loop_cost as k5
    from bpt_tpu_torch.tools import loop_cost as tool
    from bpt_tpu_torch.utils.profiling import device_trace

    dev = torch.device("cuda")
    # ---- 34. parity: kernel against plain on the card, bit for bit ----------
    rng = np.random.default_rng(9)
    shrink = np.where(rng.random((64, 1)) < 0.5, -2e-3, 0.0)  # rows that shrink the tile: the flag clears
    inputs = [("tool", tool.table(), tool.tile_input(0), LOOP_PARITY_ITERS),
              ("seeded", (1.0 + rng.uniform(-1e-3, 1e-3, k5.TAB_SHAPE) + shrink).astype(np.float32),
               rng.uniform(0.5, 1.5, k5.TILE).astype(np.float32), LOOP_PARITY_ITERS)]
    inputs += [(label, tab_np, x_np, LOOP_RISE_ITERS) for label, tab_np, x_np in loop_cost_rise_inputs()]
    errs, plain = {}, {}
    for config in k5.CONFIGS:
        rises = []
        for label, tab_np, x_np, n_iter in inputs:
            tab, x = torch.from_numpy(tab_np).to(dev), torch.from_numpy(x_np).to(dev)
            got = k5.loop_cost(tab, x, n_iter, *config)
            flags = []
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            ref = k5.loop_cost_reference(tab, x, n_iter, *config, flags=flags)
            end.record()
            torch.cuda.synchronize()
            if label == "tool":
                plain[config] = start.elapsed_time(end)
            differ = got != ref
            err = (got[differ] - ref[differ]).abs().max().item() if bool(differ.any()) else 0.0
            errs[config] = max(errs.get(config, 0.0), err)
            set_flags = sum(bool(f) for f in flags)
            if not torch.equal(got, ref):
                raise AssertionError(f"loop_cost kernel {config} disagrees with its plain version ({label} inputs)")
            if label.endswith("rises"):
                rises.append(set_flags)
                continue
            phase("parity-loop-cost", f"ops {config[0]} reduce {int(config[1])} cond {int(config[2])}, {label} "
                                      f"inputs, {n_iter} iterations: bit-equal "
                                      f"{bool(torch.equal(got, ref))}, finite {bool(torch.isfinite(got).all())}, "
                                      f"max_abs_err {err}" + (f", flag set in {set_flags} of {len(flags)} iterations"
                                                              if config[1] else ""))
        if config[1] and rises != [LOOP_RISE_ITERS] * len(rises):
            raise AssertionError(f"loop_cost {config}: the one rising element did not set the flag: {rises}")
        phase("parity-loop-cost", f"ops {config[0]} reduce {int(config[1])} cond {int(config[2])}, one rising "
                                  f"element in each of the tile's {len(rises)} rows in turn (the shrinking table), "
                                  f"{LOOP_RISE_ITERS} iterations each: bit-equal in all"
                                  + (f", flag set in {sum(rises)} of {LOOP_RISE_ITERS * len(rises)} iterations"
                                     if config[1] else ""))

    # ---- 35. the tool's main path: its seven configurations on the card -------
    k5.reset_launches()
    results = tool.main(["--iters", str(LOOP_ITERS)])
    torch.cuda.synchronize()
    launches = dict(k5.LAUNCHES)
    phase("main-loop-cost", f"python -m bpt_tpu_torch.tools.loop_cost --iters {LOOP_ITERS}: launches "
                            + ", ".join(f"{c}: {n}" for c, n in launches.items()))
    x_last = torch.from_numpy(tool.tile_input(tool.TIMED_CALLS - 1)).to(dev)
    for r in results:  # the table's entries are >= 1: every chain grows the tile; the bare loop keeps it
        out = r["out"]
        grew = bool((out > x_last).all()) if r["config"][0] else bool(torch.equal(out, x_last))
        if out.shape != x_last.shape or bool(torch.isnan(out).any()) or not grew:
            raise AssertionError(f"loop_cost {r['config']}: the tool's output is not what its data give")
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a loop_cost configuration was not launched on the main path: {launches}")

    # ---- 36. timing: ns/iter, device time, bound and share; SASS; a trace ----
    sass = loop_cost_sass(build.build(k5.KERNEL))
    tab, x = torch.from_numpy(tool.table()).to(dev), torch.from_numpy(tool.tile_input(0)).to(dev)
    for _ in range(LOOP_CLOCK_LAUNCHES):  # the card under K5's load while nvidia-smi reads its SM clock
        k5.loop_cost(tab, x, LOOP_CLOCK_ITERS, 320, False, False)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    entries = []
    for r in results:
        config = r["config"]
        n_ops, red, cond = config
        cluster, values = k5.mapping(config)
        name = f"loop_cost_kernel<{n_ops},{str(red).lower()},{str(cond).lower()},{cluster}>"
        dev_ms = kernel_device_ms(lambda: k5.loop_cost(tab, x, LOOP_ITERS, *config), iters=3, name=name, tries=5)
        flop, nbytes = loop_cost_work(LOOP_ITERS, n_ops, red)
        bound_ms, bound_by = bound(flop, nbytes)
        share = 100 * bound_ms / (dev_ms or r["ms"])
        plain_ns = plain[config] * 1e6 / LOOP_PARITY_ITERS
        code = sass.get(config)
        phase("timing-loop-cost", f"{card} (SM clock under K5's load, max: {clocks}): ops {n_ops} reduce {int(red)} "
                                  f"cond {int(cond)}, a cluster of {cluster} block(s) x 256 threads, {values} "
                                  f"value(s) a thread, {LOOP_ITERS} iterations: {r['ns_per_iter']:.2f} ns/iter, "
                                  f"{r['ms']:.4f} ms a launch (CUDA events over 5 launches), device {dev_ms} ms "
                                  f"(profiler); {flop / 1e9:.4f} GFLOP + {nbytes / 1e3:.3f} KB -> bound "
                                  f"{bound_ms:.6f} ms ({bound_by}), {share:.4f}% of it reached; plain version "
                                  f"{plain[config]:.2f} ms for {LOOP_PARITY_ITERS} iterations ({plain_ns:.0f} "
                                  f"ns/iter); SASS " + (json.dumps(code) if code else "not read"))
        if code is not None and code["backward_branches"] == 0:
            raise AssertionError(f"loop_cost_kernel {config}: no loop left in its SASS")
        entries.append({
            "name": f"loop_cost_ops{n_ops}_reduce{int(red)}_cond{int(cond)}",
            "route": "cuda",
            "source": "bpt_tpu_torch/csrc/loop_cost.cu",
            "replaces": "tools/loop_cost.py:57",
            "launches": launches[config],
            "max_abs_err": errs[config],
            "ms": r["ms"],
            "device_ms": dev_ms,
            "n_iter": LOOP_ITERS,
            "ns_per_iter": r["ns_per_iter"],
            "mapping": {"cluster": cluster, "values_per_thread": values},
            "plain_ms": plain[config],
            "plain_n_iter": LOOP_PARITY_ITERS,
            "plain_ns_per_iter": plain_ns,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "share_pct": share,
            "library_ms": None,
            "sass": code,
        })
    # the dependency chain's floor: n_iter x n_ops x the cost of one chain step, that step from the slope
    # of the CUDA-event time per iteration between ops 100 and ops 320: both are timed alike, so a
    # launch's fixed cost cancels, and events are read in every run where late in this process a
    # profiler session may record only part of a launch
    per_iter = {r["config"]: r["ns_per_iter"] for r in results}
    step_ns = (per_iter[(320, False, False)] - per_iter[(100, False, False)]) / 220
    sm_mhz = float(clocks.split(",")[0].split()[0])
    for entry, r in zip(entries, results):
        entry["chain_floor_ms"] = LOOP_ITERS * r["config"][0] * step_ns / 1e6
    phase("timing-loop-cost", f"{card}: a chain step costs {step_ns:.4f} ns = {step_ns * sm_mhz / 1e3:.3f} cycles at "
                              f"the SM clock under load ({sm_mhz:.0f} MHz; slope of the CUDA-event ns/iter from ops 100 to "
                              f"ops 320); "
                              f"chain floor n_iter x n_ops x step at {LOOP_ITERS} iterations: "
                              + "; ".join(f"{r['config']} {e['chain_floor_ms']:.4f} ms (measured "
                                          f"{e['device_ms'] or e['ms']:.4f} ms, roofline bound {e['bound_ms']:.6f} ms)"
                                          for e, r in zip(entries, results)))

    big = (320, True, True)
    for session in range(1, 6):  # a profiler session now and then records no device activity on the card
        with tempfile.TemporaryDirectory() as logdir:
            with device_trace(logdir):
                k5.loop_cost(tab, x, 10, *big)
                torch.cuda.synchronize()
            traces = [json.loads(t.read_text()) for t in Path(logdir).glob("*.pt.trace.json")]
        in_trace = any("loop_cost_kernel" in ev.get("name", "") for t in traces for ev in t["traceEvents"])
        if in_trace:
            break
    phase("timing-loop-cost", f"utils.profiling: device_trace wrote {len(traces)} Chrome trace(s), the kernel in "
                              f"it: {in_trace} (session {session})")
    if len(traces) != 1:
        raise AssertionError("utils.profiling: device_trace wrote no trace")
    return entries


TILES = 4  # the sharded phase's row tiles of the SIZE² film
BOUNDARY_SIZE = 64
FIDELITY_SIZE = 256
PROFILE_SIZE, PROFILE_FRAMES = 512, 8  # tools.helmet_profile's defaults


def checkpoint_path(bn: torch.Tensor) -> int:
    """Phase 37: a 1024² Cornell ProgressiveRenderer on the card renders 3
    frames, is saved with its generator (utils.checkpoint.save_renderer) and
    loaded into a fresh renderer that renders 2 more: equal bit for bit to
    5 uninterrupted frames.  Returns K1's launches in that run."""
    import tempfile

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import megakernel
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu_torch.utils.checkpoint import load_renderer, save_renderer

    cfg, camera = IntegratorConfig(bounces=BOUNCES), cornell_camera()

    def renderer(seed):
        return ProgressiveRenderer(cornell_scene(), cfg, SIZE, SIZE, seed=seed)

    megakernel.reset_launches()
    whole, part = renderer(11), renderer(11)
    for _ in range(5):
        whole.render_sample(camera)
    for _ in range(3):
        part.render_sample(camera)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_renderer(f"{tmp}/renderer.pt", part)
        resumed = load_renderer(path, renderer(12))
    for _ in range(2):
        resumed.render_sample(camera)
    torch.cuda.synchronize()
    launches = megakernel.LAUNCHES["cornell"]
    other = sum(megakernel.LAUNCHES.values()) + sum(megakernel.GRAD_LAUNCHES.values()) - launches
    same = torch.equal(resumed.state.accum, whole.state.accum)
    phase("checkpoint", f"{SIZE}x{SIZE}, {BOUNCES} bounces, Cornell: 3 frames, save_renderer / load_renderer into a "
                        f"fresh renderer (another seed), 2 more: accumulation {'bit-equal' if same else 'DIFFERS'} to "
                        f"5 uninterrupted frames (sample_counter {resumed.state.sample_counter}); K1 launches "
                        f"{launches} (others {other})")
    if not (same and resumed.state.sample_counter == 5.0 and launches == 10 and other == 0):
        raise AssertionError("a renderer resumed from its checkpoint does not render the frames it would have")
    return launches


def sharded_path(card: str, bn: torch.Tensor, capacity) -> tuple[list, dict]:
    """Phase 38: row-sharded rendering.  (a) The K2 route: the capacity mesh
    and the Cornell box at SIZE², 4 bounces, as TILES staged pools of
    SIZE/TILES rows at their row offsets (trace_frames_fused with
    full_height), joined bit-equal to the K1 frame and to the plain pools
    on every plane, each scene's K2 and key launches counted on their own;
    the pools' phases against one SIZE-row pool (CUDA events, profiler).  (b)
    sharded_render_frame, the light colour's gradient through replicate /
    sum_over_tiles and sharded_screen_output under a 1-rank NCCL group
    (the card is one GPU: no multi-GPU number), equal to render_frame, its
    gradient and screen_output.  (c) One sharded wavefront frame on the
    capacity mesh at FIDELITY_SIZE² through K3, equal to trace_image, and a
    half-film row tile equal to its rows.  Returns the K2 row-pool entries
    and fields for the K3 and key entries."""
    import socket

    import torch.distributed as dist

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.integrator.frame import render_frame, trace_image
    from bpt_tpu_torch.kernels import megakernel, staged
    from bpt_tpu_torch.kernels import traverse as closest_hit
    from bpt_tpu_torch.parallel import (make_mesh, sharded_render_frame, sharded_screen_output, sharded_trace,
                                        sum_over_tiles)
    from bpt_tpu_torch.parallel.multihost import initialize
    from bpt_tpu_torch.postprocess import screen_output
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene

    dev = torch.device("cuda")
    cfg = IntegratorConfig(bounces=BOUNCES)
    rows = SIZE // TILES
    offsets = [i * rows for i in range(TILES)]
    cells = {"mesh": (gltf_scene(capacity, device=dev), gltf_camera(dev)),
             "cornell": (cornell_scene(device=dev), cornell_camera(device=dev))}

    # ---- (a) K2 pools at absolute rows --------------------------------------------
    def tile_pool(scene, cam, r0, record=None, lane_counts=None):
        return staged.trace_staged(scene, cam, cfg, SIZE, rows, (2.0,), (RAND_VEC2,), bn, row_offset=r0,
                                   full_height=SIZE, record=record, lane_counts=lane_counts)[0]

    def whole_pool(scene, cam, record=None):
        return staged.trace_staged(scene, cam, cfg, SIZE, SIZE, (2.0,), (RAND_VEC2,), bn, record=record)[0]

    joined, measured, entries = {}, {}, []
    for key, (scene, cam) in cells.items():
        megakernel.reset_launches()
        tiles = [megakernel.trace_frames_fused(scene, cam, cfg, SIZE, rows, (2.0,), (RAND_VEC2,), bn,
                                               full_height=SIZE, row_offset=r0) for r0 in offsets]
        torch.cuda.synchronize()
        n_phase, n_key = megakernel.STAGED_LAUNCHES[key], sum(staged.KEY_LAUNCHES.values())
        k1_during = sum(megakernel.LAUNCHES.values())
        joined[key] = [torch.cat([t[i][0] for t in tiles]) for i in range(5)]
        ref = megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        err = max((a - b).abs().max().item() for a, b in zip(joined[key], ref))
        equal = all(torch.equal(a, b) for a, b in zip(joined[key], ref))
        phase("sharded", f"(a) {key}: {TILES} staged pools of {rows} rows at row_offset {offsets} of a {SIZE}x{SIZE} "
                         f"film, joined: {'bit-equal' if equal else 'DIFFERENT'} to the K1 frame on all 5 planes "
                         f"(max_abs_err {err}); K2 phase launches {n_phase}, key kernel launches {n_key}, K1 "
                         f"launches while the pools ran {k1_during}")
        if not equal or n_phase != TILES * BOUNCES:
            raise AssertionError(f"the row-tile pools of {key} differ from the whole frame or missed K2")
        if n_key != TILES * (BOUNCES - 1) or k1_during != 0:
            raise AssertionError(f"the row-tile pools of {key} did not sort through the key kernel alone")
        measured[key] = (n_phase, n_key, err)

    def phase_sum(run):
        sums = []
        for _ in range(3):
            rec = []
            run(rec)
            torch.cuda.synchronize()
            sums.append(sum(a.elapsed_time(b) for (_, a), (label, b) in zip(rec, rec[1:]) if label.startswith("phase")))
        return float(np.mean(sums))

    for key, (scene, cam) in cells.items():
        has_mesh = scene.mesh is not None
        name = instance(False, "none", "quad", has_mesh, kernel="phase_kernel")
        tiles_ms = event_ms(lambda: [tile_pool(scene, cam, r0) for r0 in offsets], iters=3, warmup=1)
        whole_ms = event_ms(lambda: whole_pool(scene, cam), iters=3, warmup=1)
        tiles_phases = phase_sum(lambda rec: [tile_pool(scene, cam, r0, rec) for r0 in offsets])
        whole_phases = phase_sum(lambda rec: whole_pool(scene, cam, rec))
        dev_tiles = kernel_device_ms(lambda: [tile_pool(scene, cam, r0) for r0 in offsets], 2, name)
        dev_whole = kernel_device_ms(lambda: whole_pool(scene, cam), 2, name)
        lanes = []
        t0 = time.perf_counter()
        plain = [tile_pool(scene, cam, r0, lane_counts=lanes) for r0 in offsets]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        plain = [torch.cat([t[i][0] for t in plain]) for i in range(5)]
        plain_err = max((a - b).abs().max().item() for a, b in zip(joined[key], plain))
        plain_equal = all(torch.equal(a, b) for a, b in zip(joined[key], plain))
        phase("sharded", f"(a) {key}: the {TILES} plain pools (trace_phase_reference at the same row offsets), "
                         f"joined: {'bit-equal' if plain_equal else 'DIFFERENT'} to the joined kernel pools on all "
                         f"5 planes (max_abs_err {plain_err})")
        if not plain_equal:
            raise AssertionError(f"the row-tile kernel pools of {key} differ from their plain version")
        n_q, n_s = scene.quads.v0.shape[0], 0 if scene.spheres is None else scene.spheres.color.shape[0]
        flop = nbytes = 0.0
        for i in range(TILES):  # each tile's pool: its own boundaries
            f, b = staged_work(lanes[i * BOUNCES:(i + 1) * BOUNCES], 1, SIZE * rows, pixels=SIZE * rows,
                               n_quads=n_q, n_spheres=n_s, mesh=has_mesh)
            flop, nbytes = flop + f, nbytes + b
        bound_ms, bound_by = bound(flop, nbytes)
        dev_pools = None if dev_tiles is None else dev_tiles * TILES * BOUNCES
        share = f"{100 * bound_ms / dev_pools:.2f}% of it reached" if dev_pools else "not measured"
        phase("sharded", f"{card}: (a) {key}, {TILES} pools of {rows} rows against one {SIZE}-row pool: whole pools "
                         f"{tiles_ms:.3f} against {whole_ms:.3f} ms; their phases (CUDA events) {tiles_phases:.4f} "
                         f"against {whole_phases:.4f} ms ({100 * (tiles_phases / whole_phases - 1):+.1f}%); K2 device "
                         f"{dev_tiles} against {dev_whole} ms a launch (profiler), {dev_pools} ms for the {TILES} "
                         f"pools; {flop / 1e9:.4f} GFLOP + {nbytes / 1e6:.3f} MB -> bound {bound_ms:.4f} ms "
                         f"({bound_by}), {share}; plain pools {plain_ms:.1f} ms")
        entries.append({"name": f"staged_rows_{key}", "route": "cuda", "source": "bpt_tpu_torch/csrc/staged.cu",
                        "replaces": "bpt_tpu/kernels/megakernel.py:2619", "launches": measured[key][0],
                        "key_launches": measured[key][1], "max_abs_err": max(measured[key][2], plain_err),
                        "ms": tiles_phases,
                        "device_ms": dev_pools, "whole_pool_phases_ms": whole_phases,
                        "whole_pool_device_ms": None if dev_whole is None else dev_whole * BOUNCES,
                        "pools_ms": tiles_ms, "whole_pool_ms": whole_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None})

    # ---- (b) the wavefront frame, its gradient and the display under NCCL ---------------
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize(f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        scene, cam = cells["cornell"]
        prev = torch.zeros((SIZE, SIZE, 4), device=dev)
        lc0 = torch.tensor([10.0, 10.0, 10.0], device=dev)

        def lit(lc):
            return scene._replace(quads=scene.quads._replace(color=torch.cat([scene.quads.color[:5], lc[None]])))

        lc = lc0.clone().requires_grad_(True)
        frame = sharded_render_frame(lit(lc), cam, cfg, prev, 2.0, False, RAND_VEC2, bn, mesh)
        sum_over_tiles(frame[..., :3].sum(), mesh).div(SIZE * SIZE * 3).backward()
        lc_ref = lc0.clone().requires_grad_(True)
        frame_ref = render_frame(lit(lc_ref), cam, cfg, prev, 2.0, False, RAND_VEC2, bn)
        frame_ref[..., :3].mean().backward()
        acc, acc_ref = frame.detach(), frame_ref.detach()
        for f in (2, 3):
            acc = sharded_render_frame(scene, cam, cfg, acc, float(f + 1), False, RAND_VEC2, bn, mesh)
            acc_ref = render_frame(scene, cam, cfg, acc_ref, float(f + 1), False, RAND_VEC2, bn)
        display = sharded_screen_output(acc, 1.0 / 3.0, mesh)
        rel = ((lc.grad - lc_ref.grad).abs() / lc_ref.grad.abs()).max().item()
        ok = (torch.equal(frame, frame_ref) and torch.equal(acc, acc_ref) and rel <= 1e-5
              and torch.equal(display, screen_output(acc_ref, 1.0 / 3.0)))
        phase("sharded", f"(b) {dist.get_backend()} group of {dist.get_world_size()} rank (the card is one GPU: the "
                         f"group is 1-way, no multi-GPU number is claimed): sharded_render_frame at {SIZE}x{SIZE} "
                         f"{'equal' if ok else 'NOT equal'} to render_frame over 3 frames, the light colour's "
                         f"gradient {lc.grad.tolist()} against {lc_ref.grad.tolist()} (rel {rel:.1e}), "
                         f"sharded_screen_output against screen_output")
        if not ok or dist.get_backend() != "nccl":
            raise AssertionError("the NCCL-sharded frame, gradient or display differs from the single process")

        # ---- (c) the sharded wavefront on the capacity mesh through K3 --------------------
        scene, cam = cells["mesh"]
        closest_hit.reset_launches()
        got = sharded_trace(scene, cam, cfg, FIDELITY_SIZE, FIDELITY_SIZE, 2.0, RAND_VEC2, bn, mesh)
        torch.cuda.synchronize()
        k3_launches = closest_hit.LAUNCHES["closest_hit"]
        ref = trace_image(scene, cam, cfg, FIDELITY_SIZE, FIDELITY_SIZE, 2.0, RAND_VEC2, bn, plain_walk=True)
        half = FIDELITY_SIZE // 2
        tile = trace_image(scene, cam, cfg, FIDELITY_SIZE, FIDELITY_SIZE, 2.0, RAND_VEC2, bn, tile_rows=half,
                           row_offset=half)
        equal = all(torch.equal(a, b) for a, b in zip(got, ref)) and all(
            torch.equal(a, b[half:]) for a, b in zip(tile, ref))
        k3_dev = kernel_device_ms(lambda: sharded_trace(scene, cam, cfg, FIDELITY_SIZE, FIDELITY_SIZE, 2.0,
                                                        RAND_VEC2, bn, mesh), 2, "closest_hit_kernel")
        phase("sharded", f"(c) sharded_trace on the capacity mesh at {FIDELITY_SIZE}x{FIDELITY_SIZE}: K3 launches "
                         f"{k3_launches}, {'bit-equal' if equal else 'DIFFERENT'} to trace_image with the plain walk "
                         f"(and its top half as a row tile); K3 device {k3_dev} ms a launch (profiler)")
        if not equal or k3_launches != BOUNCES:
            raise AssertionError("the sharded wavefront did not go through K3 or differs from the plain walk")
    finally:
        dist.destroy_process_group()
    return entries, {"closest_hit": {"sharded_launches": k3_launches, "sharded_device_ms": k3_dev},
                     "staged_key": {"rows_launches": sum(m[1] for m in measured.values())}}


def boundary_path(bn: torch.Tensor) -> None:
    """Phase 39: both boundary-gradient terms (diff.silhouette, diff.shadow;
    plain torch, no kernel) on the card at BOUNDARY_SIZE², the scene of the
    JAX package's boundary tests, against the same call on the CPU: finite
    and within 1e-4 relative."""
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.diff.shadow import first_receivers, quad_shadow_boundary_gradient
    from bpt_tpu_torch.diff.silhouette import sphere_silhouette_gradient
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.scenes.cornell import cornell_scene
    from bpt_tpu_torch.utils.transforms import invert_rigid, trs_matrix

    base = cornell_scene()
    inv = base.spheres.inv_matrix.clone()
    inv[0] = invert_rigid(trs_matrix(translation=(-22.5, -33.9, -10.0), scale=(16.0, 16.0, 16.0)))
    scene = base._replace(spheres=base.spheres._replace(inv_matrix=inv))
    cam = Camera.look(position=(0.0, -20.0, -120.0), fov=0.8, focus_distance=113.0)
    cfg = IntegratorConfig(bounces=2)
    n = BOUNDARY_SIZE
    yy, xx = np.mgrid[0:n, 0:n]
    pix = torch.as_tensor(np.stack([xx.ravel() + 0.5, yy.ravel() + 0.5], -1).astype(np.float32))
    rows = []
    for term in ("silhouette", "shadow"):
        values = []
        for dev in ("cpu", "cuda"):
            s, c, b = scene.to(dev), cam.to(dev), bn.to(dev)

            def center(x, dev=dev):
                return torch.stack([x, torch.tensor(-33.9, device=dev), torch.tensor(-10.0, device=dev)]), 16.0

            def weight(p):
                return torch.full(p.shape[:-1] + (3,), 1.0 / (n * n * 3), device=p.device)

            if term == "silhouette":
                v = sphere_silhouette_gradient(lambda th: s, -22.5, center, c, cfg, n, n, weight, 2.0, RAND_VEC2, b,
                                               n_samples=64, n_paths=2, eps_px=1.4)
            else:
                v = quad_shadow_boundary_gradient(lambda th: s, -22.5, center, c, cfg, n, n, weight, pix.to(dev), 2.0,
                                                  RAND_VEC2, b, n_phi=64)
            values.append(float(v))
        rel = abs(values[1] - values[0]) / max(abs(values[0]), 1e-30)
        rows.append(f"{term} card {values[1]:.9g} / CPU {values[0]:.9g} (rel {rel:.2e})")
        if not (np.isfinite(values).all() and values[0] != 0.0 and rel <= 1e-4):
            raise AssertionError(f"the {term} boundary term on the card disagrees with the CPU: " + rows[-1])
    valid = first_receivers(scene.to("cuda"), cam.to("cuda"), cfg, n, n, pix.cuda(), 2.0, RAND_VEC2, bn)[3]
    phase("boundary", f"{n}x{n}, 2 bounces, sphere 0 at x -22.5: " + "; ".join(rows)
                      + f"; NEE receivers {int(valid.sum())} of {n * n}")


def fidelity_path(card: str, bn: torch.Tensor, capacity) -> dict:
    """Phase 40: tools.fidelity's function on the capacity mesh at
    FIDELITY_SIZE² (the fused route, K1, against the wavefront, K3), and
    tools.helmet_profile's variants on it at the tool's own size
    (PROFILE_SIZE², PROFILE_FRAMES-frame pools).  Returns the K1
    and K3 launches of the fidelity run."""
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import megakernel
    from bpt_tpu_torch.kernels import traverse as closest_hit
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene
    from bpt_tpu_torch.tools.fidelity import fidelity, line
    from bpt_tpu_torch.tools.helmet_profile import profile

    scene, cam = gltf_scene(capacity, device=torch.device("cuda")), gltf_camera(torch.device("cuda"))
    megakernel.reset_launches()
    closest_hit.reset_launches()
    f = fidelity(scene, cam, IntegratorConfig(bounces=BOUNCES), FIDELITY_SIZE, bn)
    torch.cuda.synchronize()
    launches = {"k1": megakernel.LAUNCHES["mesh"], "k3": closest_hit.LAUNCHES["closest_hit"]}
    phase("fidelity", line("capacity", FIDELITY_SIZE, BOUNCES, int(capacity.p0.shape[0]), f)
                      + f"; K1 launches {launches['k1']}, K3 launches {launches['k3']}")
    if launches != {"k1": 1, "k3": BOUNCES} or not np.isfinite(list(f.values())).all():
        raise AssertionError("the fidelity tool did not run K1 against the wavefront through K3")
    rows = profile(scene, cam, PROFILE_SIZE, PROFILE_FRAMES, bn)
    phase("fidelity", f"{card}: helmet_profile's variants on the capacity mesh at {PROFILE_SIZE}x{PROFILE_SIZE}, "
                      f"{PROFILE_FRAMES} frames a pool: "
                      + "; ".join(f"{r['name']} {r['ms']:.3f} ms ({r['mrays']:.1f} Mrays/s)" for r in rows))
    return launches


def main() -> int:
    # ---- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.diff.inverse import optimize, render_avg
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.integrator.frame import trace_image
    from bpt_tpu_torch.kernels import build, megakernel, staged
    from bpt_tpu_torch.kernels import loop_cost as k5
    from bpt_tpu_torch.kernels import texel_grad
    from bpt_tpu_torch.kernels import traverse as closest_hit
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu_torch.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene
    from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene, sky_camera
    from bpt_tpu_torch.scenes.types import METAL, TRANSPARENT

    dev = torch.device("cuda")
    card = nvidia_smi()
    nvcc_version = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                                  check=True, timeout=60).stdout.strip().splitlines()[-1]
    phase("device", f"{card} | torch {torch.__version__} | CUDA {torch.version.cuda} | nvcc {nvcc_version}")

    # ---- 2. build: every kernel at once, one nvcc each --------------------------
    t0 = time.perf_counter()
    megakernel._library()  # the first load builds every kernel of csrc/
    staged._library()
    staged._key_library()
    closest_hit._library()
    texel_grad._library()
    k5._library()
    libraries = [build.build(name) for name in build.kernels()]  # already built: their paths
    phase("build", f"{megakernel.KERNEL}, {staged.KERNEL}, {staged.KEY_KERNEL}, {closest_hit.KERNEL}, "
                   f"{texel_grad.KERNEL} and {k5.KERNEL} ready in {time.perf_counter() - t0:.2f} s "
                   f"(flags {' '.join(build.NVCC_FLAGS)})")
    for lib in libraries:
        log = lib.with_suffix(".so.log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                phase("build", line.strip())

    # ---- 3. kernel against its plain version -------------------------------
    cfg = IntegratorConfig(bounces=BOUNCES)
    bn = torch.as_tensor(blue_noise_table()).to(dev)
    cam = cornell_camera(device=dev)
    max_err = 0.0
    for mat in (METAL, TRANSPARENT):
        scene = cornell_scene(right_sphere_mat=mat, device=dev)
        got = megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        ref = megakernel.trace_image_fused_reference(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        torch.cuda.synchronize()
        stats = compare(got, ref)
        phase("parity", f"right sphere mat {mat}: " + json.dumps(stats))
        if not stats["ok"]:
            raise AssertionError(f"kernel disagrees with its plain version (mat {mat})")
        max_err = max(max_err, stats["max_abs_err"])
    # the quad test: the Cornell box takes the parallelogram test (above); the two fans, asked for, and a
    # sheared quad (no parallelogram: decided the fans) are bit-equal to their plain versions too
    skewed = cornell_scene(device=dev)
    v2 = skewed.quads.v2.clone()
    v2[0] += torch.tensor([5.0, 0.0, 0.0], device=dev)
    skewed = skewed._replace(quads=skewed.quads._replace(v2=v2))
    fast = megakernel.trace_image_fused(cornell_scene(device=dev), cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
    for label, qscene, fq in (("two fans asked for", cornell_scene(device=dev), False),
                              ("a sheared quad, decided", skewed, None)):
        got = megakernel.trace_image_fused(qscene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, fast_quads=fq)
        ref = megakernel.trace_image_fused_reference(qscene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, fast_quads=fq)
        g_got, g_sg, _ = megakernel.trace_image_fused_grads(qscene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn,
                                                            fast_quads=fq)
        g_ref, g_sg_ref, _ = megakernel.trace_image_fused_grads_reference(qscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                          RAND_VEC2, bn, fast_quads=fq)
        torch.cuda.synchronize()
        stats, g_stats = compare(got, ref), compare(g_got, g_ref)
        sg_err = (g_sg - g_sg_ref).abs().max().item()
        phase("parity", f"{label}: " + json.dumps(stats) + f"; grads mode sg max_abs_err {sg_err}, planes "
                        + json.dumps(g_stats))
        if not (stats["ok"] and g_stats["ok"] and sg_err == 0.0):
            raise AssertionError(f"the kernel's two fans disagree with their plain version ({label})")
        if label.startswith("two") and torch.equal(got.color, fast.color):
            raise AssertionError("the Cornell frame through the two fans equals the parallelogram test's bit for bit: "
                                 "the kernel ignores fast_quads")
        max_err = max(max_err, stats["max_abs_err"], g_stats["max_abs_err"], sg_err)

    # ---- 4. the serving path: progressive render through the kernel -------
    renderer = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=BOUNCES), SIZE, SIZE)
    if renderer.device.type != "cuda":
        raise AssertionError(f"a renderer with no device argument runs on {renderer.device}")
    camera = cornell_camera()
    megakernel.reset_launches()
    img = renderer.render(camera, spp=SPP)
    torch.cuda.synchronize()
    launches = megakernel.LAUNCHES["cornell"]
    grad_launches = sum(megakernel.GRAD_LAUNCHES.values()) + sum(megakernel.LAUNCHES.values()) - launches
    if launches != SPP or grad_launches != 0:
        raise AssertionError(f"{launches} forward / {grad_launches} grads launches for {SPP} frames")
    if tuple(img.shape) != (SIZE, SIZE, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("display is not a finite (H, W, 3) image")
    if img.min().item() < 0.0 or img.max().item() > 1.0:
        raise AssertionError("display leaves [0, 1]")
    radiance = renderer.state.accum[..., :3].sum(-1)
    top, bottom = radiance[-SIZE // 4:].mean().item(), radiance[: SIZE // 4].mean().item()
    if not top > bottom:
        raise AssertionError(f"ceiling light: top quarter {top} not brighter than bottom {bottom}")
    if renderer.state.sample_counter != SPP:
        raise AssertionError(f"sample_counter {renderer.state.sample_counter} after {SPP} samples")
    renderer.render_sample(camera._replace(position=camera.position + torch.tensor([1.0, 0.0, 0.0])))
    if renderer.state.sample_counter != 1.0:
        raise AssertionError("moving the camera did not reset sample_counter to 1")
    phase("main", f"{SIZE}x{SIZE}, {SPP} spp: {launches} launches, display in "
                  f"[{img.min().item():.4f}, {img.max().item():.4f}], radiance top/bottom quarter "
                  f"{top:.4f}/{bottom:.4f}, motion resets sample_counter to 1")

    # ---- 5. timing ----------------------------------------------------------
    scene = cornell_scene(device=dev)
    ms_kernel = event_ms(lambda: megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn),
                        iters=50, warmup=5)
    ms_plain = event_ms(
        lambda: megakernel.trace_image_fused_reference(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn),
        iters=5, warmup=2)
    ms_frame = event_ms(lambda: renderer.render_sample(camera), iters=20, warmup=3)
    rays = SIZE * SIZE * BOUNCES
    lanes = []
    trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, lane_counts=lanes, fast_quads=None)
    nq, ns = scene.quads.v0.shape[0], scene.spheres.color.shape[0]
    flop, nbytes = kernel_work(lanes, nq, ns, SIZE * SIZE)
    bound_ms, bound_by = bound(flop, nbytes)
    fans_flop, fans_bytes = kernel_work(lanes, nq, ns, SIZE * SIZE, as_fans=True)
    fans_ms = bound(fans_flop, fans_bytes)[0]
    live = [int(c.live) for c in lanes]
    par = sum(int(c.parallelogram_tests) for c in lanes)
    if par != sum(live) * nq:
        raise AssertionError(f"the plain run made {par} parallelogram tests, not one per live lane and quad")
    phase("timing", f"{card}: kernel {ms_kernel:.3f} ms/frame ({rays / ms_kernel / 1e3:.1f} Mrays/s), "
                    f"plain {ms_plain:.3f} ms/frame ({rays / ms_plain / 1e3:.1f} Mrays/s), "
                    f"progressive frame through the kernel {ms_frame:.3f} ms "
                    f"({SIZE}x{SIZE}, {BOUNCES} bounces); live lanes per bounce {live}, "
                    f"{flop / 1e9:.4f} GFLOP + {nbytes / 1e6:.3f} MB -> bound {bound_ms:.4f} ms ({bound_by}); counted "
                    f"as the two fans {fans_flop / 1e9:.4f} GFLOP -> {fans_ms:.4f} ms")

    # ---- 6. grads-mode kernel against its plain version and the forward ---
    grad_err = 0.0
    for mat, tint in ((METAL, False), (TRANSPARENT, False), (TRANSPARENT, True)):
        gscene = cornell_scene(right_sphere_mat=mat, device=dev)
        gcfg = IntegratorConfig(bounces=BOUNCES, transparent_tint=tint)
        got, sg, _ = megakernel.trace_image_fused_grads(gscene, cam, gcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        ref, sg_ref, _ = megakernel.trace_image_fused_grads_reference(gscene, cam, gcfg, SIZE, SIZE, 2.0, RAND_VEC2,
                                                                      bn)
        fwd = megakernel.trace_image_fused(gscene, cam, gcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        torch.cuda.synchronize()
        stats = compare(got, ref)
        sg_err = (sg - sg_ref).abs().max().item()
        fwd_err = max((g - f).abs().max().item() for g, f in zip(got, fwd))
        phase("grad-parity", f"mat {mat} tint {tint}: sg {tuple(sg.shape)} max_abs_err {sg_err}, "
                             f"{int(sg[:nq + ns].sum().item())} counted hits, 11 planes vs plain "
                             + json.dumps(stats) + f", vs the forward kernel max_abs_err {fwd_err}")
        if not (stats["ok"] and sg_err == 0.0 and fwd_err == 0.0 and tuple(sg.shape) == tuple(sg_ref.shape)):
            raise AssertionError(f"grads kernel disagrees (mat {mat}, tint {tint})")
        grad_err = max(grad_err, stats["max_abs_err"], sg_err)

    # ---- 7. the path-replay gradient against autograd and finite differences
    wvec = torch.tensor([1.0, 2.0, 3.0], device=dev)
    gscene = cornell_scene(right_sphere_mat=TRANSPARENT, device=dev)
    lc0 = torch.tensor([10.0, 10.0, 10.0], device=dev)
    wc0, sc0 = gscene.quads.color[2].clone(), torch.tensor([0.4, 0.9, 0.6], device=dev)

    def grad_loss(lc, wc, sc, trace, gcfg, **kw):
        qc = torch.stack([lc if i == 5 else wc if i == 2 else gscene.quads.color[i] for i in range(6)])
        s = gscene._replace(quads=gscene.quads._replace(color=qc),
                            spheres=gscene.spheres._replace(color=torch.stack([gscene.spheres.color[0], sc])))
        return (trace(s, cam, gcfg, GRAD_SIZE, GRAD_SIZE, 2.0, RAND_VEC2, bn, **kw).color.double() * wvec).mean()

    h = 1e-2
    for tint in (False, True):
        gcfg = IntegratorConfig(bounces=BOUNCES, transparent_tint=tint)
        grads = {}
        for route, trace, kw in (("kernel", megakernel.trace_image_fused, dict(differentiable=True)),
                                 ("plain", megakernel.trace_image_fused_reference, {})):
            leaves = [v.clone().requires_grad_(True) for v in (lc0, wc0, sc0)]
            grads[route] = torch.autograd.grad(grad_loss(*leaves, trace, gcfg, **kw), leaves)
        fd = []
        with torch.no_grad():
            for arg, ch in ((0, 0), (1, 1), (2, 0)):
                e = torch.zeros(3, device=dev)
                e[ch] = h
                hi = [v + e if i == arg else v for i, v in enumerate((lc0, wc0, sc0))]
                lo = [v - e if i == arg else v for i, v in enumerate((lc0, wc0, sc0))]
                fd.append(((grad_loss(*hi, megakernel.trace_image_fused, gcfg)
                            - grad_loss(*lo, megakernel.trace_image_fused, gcfg)) / (2 * h)).item())
        rows = []
        for (name, ch), g, p, f in zip((("light", 0), ("wall", 1), ("sphere", 0)), grads["kernel"], grads["plain"], fd):
            g, p = g.double().cpu(), p.double().cpu()
            rel_plain = ((g - p).abs() / p.abs().clamp_min(1e-12)).max().item()
            rel_fd = abs(g[ch].item() - f) / max(abs(f), 1e-12)
            rows.append(f"{name} {g.numpy().round(8).tolist()} vs plain rel {rel_plain:.2e}, "
                        f"vs FD[{ch}] {f:.8f} rel {rel_fd:.2e}")
            if not (rel_plain <= 1e-4 and rel_fd <= 2e-2):
                raise AssertionError(f"path-replay gradient of the {name} (tint {tint}) disagrees: " + rows[-1])
        phase("grad", f"{GRAD_SIZE}x{GRAD_SIZE} tint {tint}: " + "; ".join(rows))

    # ---- 8. the training path: recover the light emission -----------------
    tcfg = IntegratorConfig(bounces=BOUNCES)
    tbase = cornell_scene(device=dev)

    def build_scene(params):
        color = torch.cat([tbase.quads.color[:5], (params["emission"] * torch.ones(3, device=dev))[None]])
        return tbase._replace(quads=tbase.quads._replace(color=color)), cam

    megakernel.reset_launches()
    t0 = time.perf_counter()
    target = render_avg(build_scene({"emission": torch.tensor(10.0, device=dev)})[0], cam, tcfg, SIZE,
                        TRAIN_FRAMES, RAND_VEC2, bn)
    result = optimize(build_scene, {"emission": 4.0}, target, tcfg, SIZE, steps=TRAIN_STEPS, lr=0.5,
                      frames=TRAIN_FRAMES)
    losses = result.losses.cpu().numpy()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches, train_grad_launches = megakernel.LAUNCHES["cornell"], megakernel.GRAD_LAUNCHES["cornell"]
    emission = float(result.params["emission"])
    phase("train", f"{SIZE}x{SIZE}, {BOUNCES} bounces, {TRAIN_STEPS} steps in {train_s:.3f} s: loss "
                   f"{losses[0]:.6g} -> {losses[-1]:.6g}, emission 4.0 -> {emission:.5f} (truth 10.0); "
                   f"launches: grads {train_grad_launches}, forward {train_launches}")
    if train_grad_launches != TRAIN_STEPS * len(TRAIN_FRAMES) or train_launches != len(TRAIN_FRAMES):
        raise AssertionError(f"training launched the grads kernel {train_grad_launches} times and the forward "
                             f"{train_launches} times")
    if not (losses[-1] < 0.05 * losses[0] and abs(emission - 10.0) < 1.0 and np.isfinite(losses).all()):
        raise AssertionError("training did not recover the light emission")
    t0 = time.perf_counter()
    warm = optimize(build_scene, {"emission": 4.0}, target, tcfg, SIZE, steps=TRAIN_STEPS, lr=0.5, frames=TRAIN_FRAMES)
    warm_losses = warm.losses.cpu().numpy()
    warm_s = time.perf_counter() - t0
    if not np.array_equal(warm_losses, losses):
        raise AssertionError("a second, warm training run took other steps")
    phase("train", f"warm rerun: {TRAIN_STEPS} steps in {warm_s:.4f} s ({warm_s / TRAIN_STEPS * 1e3:.3f} ms/step, "
                   f"{len(TRAIN_FRAMES)} frames each), the same losses")

    # ---- 9. timing of the training step (bench.py's default cell) --------
    bscene = cornell_scene(device=dev)
    step_frame = [2.0]

    def bench_step(differentiable: bool):
        lc = bscene.quads.color[5].clone().requires_grad_(differentiable)
        s = bscene._replace(quads=bscene.quads._replace(color=torch.cat([bscene.quads.color[:5], lc[None]])))
        f0 = step_frame[0]
        step_frame[0] += BENCH_FRAMES
        acc = 0.0
        for i in range(BENCH_FRAMES):
            acc = acc + megakernel.trace_image_fused(s, cam, cfg, SIZE, SIZE, f0 + i, RAND_VEC2, bn,
                                                     differentiable=differentiable).color
        loss = acc.mean()
        return torch.autograd.grad(loss, [lc])[0] if differentiable else loss

    torch.cuda.reset_peak_memory_stats()
    ms_step = event_ms(lambda: bench_step(True), iters=10, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        ms_fwd_step = event_ms(lambda: bench_step(False), iters=10, warmup=2)
    bench_rays = SIZE * SIZE * BOUNCES * BENCH_FRAMES
    ms_grad_kernel = event_ms(lambda: megakernel.trace_image_fused_grads(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                         RAND_VEC2, bn), iters=50, warmup=5)
    ms_grad_plain = event_ms(lambda: megakernel.trace_image_fused_grads_reference(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                                 RAND_VEC2, bn), iters=3, warmup=1)
    dev_fwd = kernel_device_ms(lambda: megakernel.trace_image_fused(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                      RAND_VEC2, bn), 20,
                               instance(False, "none", "quad", False))
    dev_grad = kernel_device_ms(lambda: megakernel.trace_image_fused_grads(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                             RAND_VEC2, bn), 20,
                                  instance(True, "none", "quad", False))
    qc = bscene.quads.color.clone().requires_grad_(True)
    one = megakernel.trace_image_fused(bscene._replace(quads=bscene.quads._replace(color=qc)), cam, cfg, SIZE, SIZE,
                                       2.0, RAND_VEC2, bn, differentiable=True)
    one_loss = one.color.mean()
    ms_bwd = event_ms(lambda: torch.autograd.grad(one_loss, [qc], retain_graph=True), iters=20, warmup=3)
    step_frame[0] = 2.0

    def plain_step():
        lc = bscene.quads.color[5].clone().requires_grad_(True)
        s = bscene._replace(quads=bscene.quads._replace(color=torch.cat([bscene.quads.color[:5], lc[None]])))
        acc = 0.0
        for i in range(BENCH_FRAMES):
            acc = acc + trace_image(s, cam, cfg, GRAD_SIZE, GRAD_SIZE, 2.0 + i, RAND_VEC2, bn).color
        return torch.autograd.grad(acc.mean(), [lc])[0]

    ms_plain_step = event_ms(plain_step, iters=2, warmup=1)
    host_ms, busy_ms, rows = profiled_step(lambda: bench_step(True), iters=3)
    top = "; ".join(f"{k[:60]} {ms:.4f} ms x{n:g}" for k, ms, n in rows[:10])
    from bpt_tpu_torch.tools.ab_time import step_counts

    step_ops, step_syncs = step_counts(lambda: bench_step(True))
    phase("step-profile", f"{card}: fwd+bwd step under torch.profiler: host {host_ms:.3f} ms, device busy "
                          f"{busy_ms:.3f} ms ({100 * (1 - busy_ms / host_ms):.1f}% idle), {len(rows)} kernels; "
                          f"largest per step: {top}; {step_ops} device operations and {step_syncs} host "
                          f"synchronizations a step (before the parallelogram test: {PARENT_STEP_OPS} and "
                          f"{PARENT_STEP_SYNCS} under torch {PARENT_STEP_TORCH})")
    same_torch = torch.__version__ == PARENT_STEP_TORCH
    if not same_torch:
        phase("step-profile", f"torch {torch.__version__}: the device operations are not compared with the "
                              f"parent's {PARENT_STEP_OPS}, counted under torch {PARENT_STEP_TORCH}; count the "
                              f"parent's with tools/ab_time.py --only nomesh")
    if step_ops <= 0 or (same_torch and step_ops > PARENT_STEP_OPS) or step_syncs > PARENT_STEP_SYNCS:
        raise AssertionError(f"the fwd+bwd step makes {step_ops} device operations and {step_syncs} host "
                             f"synchronizations, more than {PARENT_STEP_OPS} and {PARENT_STEP_SYNCS}")
    glanes = []
    _, gsg, _ = trace_image(bscene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, param_grads=True, lane_counts=glanes,
                            fast_quads=None)
    gflop, gbytes = kernel_work(glanes, nq, ns, SIZE * SIZE)
    n_obj = nq + ns
    plane_adds = gsg[:n_obj].sum().item() + 2 * (gsg[n_obj:] > 0).sum().item()  # the planes' adds
    gflop += plane_adds
    gbytes += gsg.shape[0] * 4 * SIZE * SIZE
    grad_bound_ms, grad_bound_by = bound(gflop, gbytes)
    grad_fans_ms = bound(kernel_work(glanes, nq, ns, SIZE * SIZE, as_fans=True)[0] + plane_adds, gbytes)[0]
    plain_rays = GRAD_SIZE * GRAD_SIZE * BOUNCES * BENCH_FRAMES
    phase("grad-timing", f"{card}: {SIZE}x{SIZE}, {BOUNCES} bounces, {BENCH_FRAMES} frames: fwd+bwd step "
                         f"{ms_step:.3f} ms ({bench_rays / ms_step / 1e3:.1f} Mrays/s, peak {peak_gb:.3f} GB), "
                         f"forward-only step {ms_fwd_step:.3f} ms ({bench_rays / ms_fwd_step / 1e3:.1f} Mrays/s); "
                         f"grads kernel {ms_grad_kernel:.3f} ms/launch through its wrapper, device "
                         f"{dev_grad} ms (forward kernel device {dev_fwd} ms); plain grads version "
                         f"{ms_grad_plain:.3f} ms; backward's torch part {ms_bwd:.3f} ms/frame; plain route "
                         f"fwd+bwd step at {GRAD_SIZE}x{GRAD_SIZE} {ms_plain_step:.3f} ms "
                         f"({plain_rays / ms_plain_step / 1e3:.1f} Mrays/s); grads bound: {gflop / 1e9:.4f} GFLOP + "
                         f"{gbytes / 1e6:.3f} MB -> {grad_bound_ms:.4f} ms ({grad_bound_by}), as the two fans "
                         f"{grad_fans_ms:.4f} ms")

    kernels = [{
        "name": "megakernel_cornell",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/megakernel.cu",
        "replaces": "bpt_tpu/kernels/megakernel.py:1183",
        "launches": launches,
        "launches_train": train_launches,
        "max_abs_err": max_err,
        "ms": ms_kernel,
        "device_ms": dev_fwd,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_fans_ms": fans_ms,
        "library_ms": None,
    }, {
        "name": "megakernel_cornell_grads",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/megakernel.cu",
        "replaces": "bpt_tpu/kernels/megakernel.py:2180",
        "launches": train_grad_launches,
        "max_abs_err": grad_err,
        "ms": ms_grad_kernel,
        "device_ms": dev_grad,
        "plain_ms": ms_grad_plain,
        "bound_ms": grad_bound_ms,
        "bound_by": grad_bound_by,
        "bound_fans_ms": grad_fans_ms,
        "library_ms": None,
    }]

    # ---- 10-14. the quadric and sky configurations --------------------------
    quadric_cfg = IntegratorConfig(bounces=BOUNCES, transparent_tint=True)
    sky_cfg = IntegratorConfig(bounces=BOUNCES, env="sky", nee="sun")
    families = {
        "quadric": dict(cfg=quadric_cfg, camera=quadric_camera, main=quadric_geometry_scene,
                        parity=[("demo (shape_k 0.5, CLEARCOAT)", quadric_geometry_scene(device=dev)),
                                ("shape_k 0.35, TRANSPARENT",
                                 quadric_geometry_scene(shape_k=0.35, all_shapes_mat=TRANSPARENT, device=dev))]),
        "sky": dict(cfg=sky_cfg, camera=sky_camera, main=physical_sky_scene,
                    parity=[("right sphere METAL", physical_sky_scene(device=dev)),
                            ("right sphere TRANSPARENT", physical_sky_scene(right_sphere_mat=TRANSPARENT,
                                                                            device=dev))]),
    }
    for fam, spec in families.items():
        fcfg, fcam = spec["cfg"], spec["camera"](device=dev)

        # ---- 10. parity: forward on both scenes, grads on the first -------
        fwd_err = grads_err = 0.0
        for label, pscene in spec["parity"]:
            got = megakernel.trace_image_fused(pscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
            ref = megakernel.trace_image_fused_reference(pscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
            torch.cuda.synchronize()
            stats = compare(got, ref)
            phase(f"parity-{fam}", f"{label}: " + json.dumps(stats))
            if not stats["ok"]:
                raise AssertionError(f"{fam} kernel disagrees with its plain version ({label})")
            fwd_err = max(fwd_err, stats["max_abs_err"])
        pscene = spec["parity"][0][1]
        got, sg, _ = megakernel.trace_image_fused_grads(pscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        ref, sg_ref, _ = megakernel.trace_image_fused_grads_reference(pscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2,
                                                                      bn)
        fwd = megakernel.trace_image_fused(pscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        torch.cuda.synchronize()
        stats = compare(got, ref)
        sg_err = (sg - sg_ref).abs().max().item()
        vs_fwd = max((g - f).abs().max().item() for g, f in zip(got, fwd))
        phase(f"parity-{fam}", f"grads mode, {spec['parity'][0][0]}: sg {tuple(sg.shape)} max_abs_err {sg_err}, "
                               f"{int(sg.sum().item())} counted hits, 11 planes vs plain " + json.dumps(stats)
                               + f", vs the forward kernel max_abs_err {vs_fwd}")
        if not (stats["ok"] and sg_err == 0.0 and vs_fwd == 0.0 and sg.shape == sg_ref.shape):
            raise AssertionError(f"{fam} grads kernel disagrees")
        grads_err = max(stats["max_abs_err"], sg_err)

        # ---- 11. the serving path --------------------------------------------
        frenderer = ProgressiveRenderer(spec["main"](), fcfg, SIZE, SIZE)
        if frenderer.device.type != "cuda":
            raise AssertionError(f"a renderer with no device argument runs on {frenderer.device}")
        mcam = spec["camera"]()
        megakernel.reset_launches()
        fimg = frenderer.render(mcam, spp=SPP)
        torch.cuda.synchronize()
        f_launches = megakernel.LAUNCHES[fam]
        others = sum(megakernel.LAUNCHES.values()) + sum(megakernel.GRAD_LAUNCHES.values()) - f_launches
        if f_launches != SPP or others != 0:
            raise AssertionError(f"{fam}: {f_launches} launches of its configuration, {others} others, for {SPP} "
                                 "frames")
        if not bool(torch.isfinite(fimg).all()) or fimg.min().item() < 0.0 or fimg.max().item() > 1.0:
            raise AssertionError(f"{fam}: display is not finite in [0, 1]")
        if fam == "quadric":
            # the demo camera sees 11 shapes (the pyramid hides the rectangle); a raised one sees all 12
            raised = Camera.look(position=(0.0, 20.0, -110.0), pitch=0.45, fov=0.8, focus_distance=113.0)
            frenderer.render_sample(raised)
            if frenderer.state.sample_counter != 1.0:
                raise AssertionError("moving the camera did not reset sample_counter to 1")
            one = megakernel.trace_image_fused(frenderer.scene, raised.to(dev), fcfg, SIZE, SIZE, 3.0, RAND_VEC2,
                                               frenderer.blue_noise)
            seen = set(torch.unique(one.object_id).tolist())
            if not set(range(12)) <= seen:
                raise AssertionError(f"quadric ids seen in one frame: {sorted(seen)}")
            detail = ("all 12 quadric ids (0-11) among the first hits of one frame from a raised camera, motion "
                      "resets sample_counter to 1")
        else:
            one = megakernel.trace_image_fused(frenderer.scene, mcam.to(dev), fcfg, SIZE, SIZE, 3.0, RAND_VEC2,
                                               frenderer.blue_noise)
            n_sky = int((one.pixel_sharpness == 1.01).sum().item())
            if n_sky == 0:
                raise AssertionError("no pixel sees the sky")
            frenderer.render_sample(mcam._replace(position=mcam.position + torch.tensor([1.0, 0.0, 0.0])))
            if frenderer.state.sample_counter != 1.0:
                raise AssertionError("moving the camera did not reset sample_counter to 1")
            detail = f"{n_sky} pixels see the sky (flag 1.01), motion resets sample_counter to 1"
        phase(f"main-{fam}", f"{SIZE}x{SIZE}, {SPP} spp: {f_launches} launches, display in "
                             f"[{fimg.min().item():.4f}, {fimg.max().item():.4f}], {detail}")

        # ---- 12. the training path --------------------------------------------
        tscene = spec["main"](device=dev)
        if fam == "quadric":
            def build_f(params, base=tscene):
                q = base.quadrics
                return base._replace(quadrics=q._replace(color=params["c"] * torch.ones(12, 3, device=dev))), fcam
            truth, start = torch.tensor(0.8, device=dev), 0.3
        else:
            def build_f(params, base=tscene):
                color = torch.cat([params["c"] * torch.ones(1, 3, device=dev), base.spheres.color[1:]])
                return base._replace(spheres=base.spheres._replace(color=color)), fcam
            truth, start = torch.tensor(0.6, device=dev), 0.2
        ftarget = render_avg(build_f({"c": truth})[0], fcam, fcfg, SIZE, TRAIN_FRAMES, RAND_VEC2, bn)
        megakernel.reset_launches()
        t0 = time.perf_counter()
        fres = optimize(build_f, {"c": start}, ftarget, fcfg, SIZE, steps=10, lr=0.05, frames=TRAIN_FRAMES)
        flosses = fres.losses.cpu().numpy()
        torch.cuda.synchronize()
        f_train_s = time.perf_counter() - t0
        f_grad_launches = megakernel.GRAD_LAUNCHES[fam]
        phase(f"train-{fam}", f"{SIZE}x{SIZE}, {BOUNCES} bounces, 10 steps in {f_train_s:.3f} s: loss "
                              f"{flosses[0]:.6g} -> {flosses[-1]:.6g}, parameter {start} -> "
                              f"{float(fres.params['c']):.5f} (truth {truth.item()}); grads launches "
                              f"{f_grad_launches}")
        if f_grad_launches != 10 * len(TRAIN_FRAMES) or not (np.isfinite(flosses).all() and flosses[-1] < flosses[0]):
            raise AssertionError(f"{fam} training did not run through the grads kernel or did not lower the loss")

        # ---- 13. timing -----------------------------------------------------
        tscene = spec["parity"][0][1]

        def fwd_call():
            return megakernel.trace_image_fused(tscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)

        def grads_call():
            return megakernel.trace_image_fused_grads(tscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)

        f_ms = event_ms(fwd_call, iters=20, warmup=3)
        g_ms = event_ms(grads_call, iters=20, warmup=3)
        f_plain = event_ms(lambda: megakernel.trace_image_fused_reference(tscene, fcam, fcfg, SIZE, SIZE, 2.0,
                                                                         RAND_VEC2, bn), iters=2, warmup=1)
        g_plain = event_ms(lambda: megakernel.trace_image_fused_grads_reference(tscene, fcam, fcfg, SIZE, SIZE, 2.0,
                                                                               RAND_VEC2, bn), iters=2, warmup=1)
        f_dev = kernel_device_ms(fwd_call, 10, instance(False, fcfg.env, fcfg.nee, False))
        g_dev = kernel_device_ms(grads_call, 10, instance(True, fcfg.env, fcfg.nee, False))
        f_frame = event_ms(lambda: frenderer.render_sample(mcam), iters=10, warmup=2)
        flanes = []
        _, fsg, _ = trace_image(tscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, param_grads=True,
                                lane_counts=flanes, fast_quads=None)
        n_q = tscene.quads.v0.shape[0]
        n_s = 0 if tscene.spheres is None else tscene.spheres.color.shape[0]
        n_qd = 0 if tscene.quadrics is None else tscene.quadrics.color.shape[0]
        fflop, fbytes = kernel_work(flanes, n_q, n_s, SIZE * SIZE, n_qd, sky=fam == "sky")
        f_bound, f_by = bound(fflop, fbytes)
        n_obj = n_q + n_s + n_qd
        plane_adds = fsg[:n_obj].sum().item() + 2 * (fsg[n_obj:] > 0).sum().item()
        gflop_f = fflop + plane_adds
        gbytes_f = fbytes + fsg.shape[0] * 4 * SIZE * SIZE
        g_bound, g_by = bound(gflop_f, gbytes_f)
        fans_flop = kernel_work(flanes, n_q, n_s, SIZE * SIZE, n_qd, sky=fam == "sky", as_fans=True)[0]
        f_fans, g_fans = bound(fans_flop, fbytes)[0], bound(fans_flop + plane_adds, gbytes_f)[0]
        if sum(int(c.parallelogram_tests) for c in flanes) != sum(int(c.live) for c in flanes) * n_q:
            raise AssertionError(f"{fam}: the plain run did not take the parallelogram test on every live lane")
        steps = [int(c.torus_steps) for c in flanes]
        misses = [int(c.misses) for c in flanes]
        phase(f"timing-{fam}", f"{card}: {SIZE}x{SIZE}, {BOUNCES} bounces: forward kernel {f_ms:.3f} ms/frame "
                               f"through its wrapper ({rays / f_ms / 1e3:.1f} Mrays/s), device {f_dev} ms; grads "
                               f"kernel {g_ms:.3f} ms, device {g_dev} ms; plain forward {f_plain:.3f} ms "
                               f"({rays / f_plain / 1e3:.1f} Mrays/s), plain grads {g_plain:.3f} ms; progressive "
                               f"frame {f_frame:.3f} ms ({rays / f_frame / 1e3:.1f} Mrays/s); live lanes per bounce "
                               f"{[int(c.live) for c in flanes]}, misses {misses}, torus steps {steps}; forward "
                               f"{fflop / 1e9:.4f} GFLOP + {fbytes / 1e6:.3f} MB -> bound {f_bound:.4f} ms ({f_by}); "
                               f"grads {gflop_f / 1e9:.4f} GFLOP + {gbytes_f / 1e6:.3f} MB -> bound {g_bound:.4f} ms "
                               f"({g_by}); counted as the two fans: forward {fans_flop / 1e9:.4f} GFLOP -> "
                               f"{f_fans:.4f} ms, grads {g_fans:.4f} ms")
        kernels += [{
            "name": f"megakernel_{fam}",
            "route": "cuda",
            "source": "bpt_tpu_torch/csrc/megakernel.cu",
            "replaces": "bpt_tpu/kernels/megakernel.py:1183",
            "launches": f_launches,
            "max_abs_err": fwd_err,
            "ms": f_ms,
            "device_ms": f_dev,
            "plain_ms": f_plain,
            "bound_ms": f_bound,
            "bound_by": f_by,
            "bound_fans_ms": f_fans,
            "library_ms": None,
        }, {
            "name": f"megakernel_{fam}_grads",
            "route": "cuda",
            "source": "bpt_tpu_torch/csrc/megakernel.cu",
            "replaces": "bpt_tpu/kernels/megakernel.py:2180",
            "launches": f_grad_launches,
            "max_abs_err": grads_err,
            "ms": g_ms,
            "device_ms": g_dev,
            "plain_ms": g_plain,
            "bound_ms": g_bound,
            "bound_by": g_by,
            "bound_fans_ms": g_fans,
            "library_ms": None,
        }]

    # ---- 14. the path-replay gradient of a quadric color ---------------------
    qscene, qcam = quadric_geometry_scene(device=dev), quadric_camera(device=dev)
    qc0, qlc0 = torch.tensor([0.8, 0.6, 0.4], device=dev), torch.tensor([10.0, 10.0, 10.0], device=dev)

    def quadric_loss(qc, lc, trace, **kw):
        colors = torch.cat([qscene.quadrics.color[:11], qc[None]])
        s = qscene._replace(quadrics=qscene.quadrics._replace(color=colors),
                            quads=qscene.quads._replace(color=torch.cat([qscene.quads.color[:5], lc[None]])))
        return (trace(s, qcam, quadric_cfg, GRAD_SIZE, GRAD_SIZE, 2.0, RAND_VEC2, bn, **kw).color.double()
                * wvec).mean()

    qgrads = {}
    for route, trace, kw in (("kernel", megakernel.trace_image_fused, dict(differentiable=True)),
                             ("plain", megakernel.trace_image_fused_reference, {})):
        leaves = [v.clone().requires_grad_(True) for v in (qc0, qlc0)]
        qgrads[route] = torch.autograd.grad(quadric_loss(*leaves, trace, **kw), leaves)
    rows = []
    with torch.no_grad():
        for arg, (name, ch) in enumerate((("quadric 11", 1), ("light", 0))):
            e = torch.zeros(3, device=dev)
            e[ch] = h
            hi = [v + e if i == arg else v for i, v in enumerate((qc0, qlc0))]
            lo = [v - e if i == arg else v for i, v in enumerate((qc0, qlc0))]
            f = ((quadric_loss(*hi, megakernel.trace_image_fused) - quadric_loss(*lo, megakernel.trace_image_fused))
                 / (2 * h)).item()
            g, pl = qgrads["kernel"][arg].double().cpu(), qgrads["plain"][arg].double().cpu()
            rel_plain = ((g - pl).abs() / pl.abs().clamp_min(1e-12)).max().item()
            rel_fd = abs(g[ch].item() - f) / max(abs(f), 1e-12)
            rows.append(f"{name} {g.numpy().round(8).tolist()} vs plain rel {rel_plain:.2e}, vs FD[{ch}] {f:.8f} "
                        f"rel {rel_fd:.2e}")
            if not (rel_plain <= 1e-4 and rel_fd <= 2e-2 and g.abs().min().item() > 0):
                raise AssertionError(f"path-replay gradient of {name} disagrees: " + rows[-1])
    phase("grad-quadric", f"{GRAD_SIZE}x{GRAD_SIZE}, tint on: " + "; ".join(rows))

    entries, capacity = mesh_and_hdri(card, bn)
    kernels += entries
    entries, stand_in_model, stand_in = textured_and_camera(card, bn)
    kernels += entries
    inference_mode_path(card, bn, capacity, stand_in)
    kernels += inverse_rendering(card, bn, capacity, stand_in, stand_in_model)
    kernels += staged_path(card, bn, capacity, stand_in)
    kernels += loop_cost_path(card)
    k1_resumed = checkpoint_path(bn)
    entries, fields = sharded_path(card, bn, capacity)
    kernels += entries
    boundary_path(bn)
    fields["closest_hit"]["fidelity_launches"] = fidelity_path(card, bn, capacity)["k3"]
    fields["megakernel_cornell"] = {"checkpoint_launches": k1_resumed}
    for entry in kernels:
        entry.update(fields.get(entry["name"], {}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
