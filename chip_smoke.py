"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device       — a CUDA device must exist; prints its name and power limit
                  (nvidia-smi) and the torch, CUDA and nvcc versions.
2. build        — builds the kernels from bpt_tpu_torch/csrc with nvcc.
3. parity       — the forward kernel against its plain PyTorch version at
                  1024², 4 bounces, frame 2, for both right-sphere materials.
4. main         — the serving path: ProgressiveRenderer (on the card by
                  default) renders the Cornell box at 1024², 8 spp; checks
                  launches, range, light placement and the motion reset.
5. timing       — CUDA-event times per frame of the forward kernel and of
                  its plain version at 1024², 4 bounces.
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
                  fwd+bwd w.r.t. the light color): ms per step and rays/s,
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
                  (torch.profiler), the plain version's time, the bound;
                  the progressive frame time and Mrays/s.
14. grad-quadric — at 256², the path-replay gradient of mean(color·[1,2,3])
                  for quadric 11's color and the light against autograd
                  through the plain trace_image (rtol 1e-4) and central
                  differences of the kernel's forward (rtol 2e-2).

It ends with a JSON line of per-kernel results (one entry per mode and
configuration, each with its bound, the least time the card could take for
the same work), the card's name and power limit, and a last JSON line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SIZE = 1024
BOUNCES = 4
SPP = 8
RAND_VEC2 = np.array([0.3, 0.7], np.float32)
GRAD_SIZE = 256
TRAIN_STEPS = 30
TRAIN_FRAMES = (1.0, 2.0)
BENCH_FRAMES = 8

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
HIT_FLOP = 24  # per hit: normal, facing test, hit point (21) + the cheapest branch (3)
# Per live bounce, the 12 shapes of csrc/quadrics.cuh, each with its 33-FLOP
# transform and its cheapest exit: sphere 68, cylinder 67, cone 96,
# paraboloid 72, hyperboloid 94, capsule 127, ring 79, box 48, pyramid 131,
# disk 44, rectangle 41, torus bound 81 (the hit's normal is not counted).
QUADRIC_SET_FLOP = 948
TORUS_STEP_FLOP = 18  # one SDF march step: the point, map_torus, t += d
SKY_FLOP = 132  # one Preetham evaluation on a miss (csrc/sky.cuh sky_color)


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


def cuda_ms(fn, iters: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of the two times."""
    t_ops, t_bytes = flop / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_work(lane_counts, n_quads: int, n_spheres: int, pixels: int, n_quadrics: int = 0,
                sky: bool = False) -> tuple[float, float]:
    """(FP32 operations, bytes) the forward kernel needs for one frame whose
    plain run reported ``lane_counts`` (per bounce: live, hit and missed
    lanes and the torus march's steps on live lanes).  Each input byte is
    read once (the blue-noise table, the packed scene, the parameter pack),
    each of the 11 output planes written once.  Sphere normals of closer
    hits, quadric normals and all but the cheapest shading branch are left
    out, so the operation count is a lower bound."""
    live = sum(int(c.live) for c in lane_counts)
    hits = sum(int(c.hits) for c in lane_counts)
    flop = (pixels * RAYGEN_FLOP + live * (n_spheres * SPHERE_FLOP + n_quads * QUAD_FLOP) + hits * HIT_FLOP
            + (live * QUADRIC_SET_FLOP if n_quadrics else 0)
            + sum(int(c.torus_steps) for c in lane_counts) * TORUS_STEP_FLOP
            + (sum(int(c.misses) for c in lane_counts) * SKY_FLOP if sky else 0))
    nbytes = (256 * 256 * 4 * 4 + 4 * (16 + 19 + 20 * n_quads + 21 * n_spheres + 20 * n_quadrics)
              + 11 * 4 * pixels)
    return flop, nbytes


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


def kernel_device_ms(fn, iters: int, name: str) -> float | None:
    """Mean device time per launch of the CUDA kernels whose name contains
    ``name`` (spaces ignored) while ``fn`` runs; None when the profiler
    reports none."""
    name = name.replace(" ", "")
    rows = [(ms, n) for key, ms, n in profiled_step(fn, iters)[2] if name in key.replace(" ", "")]
    return sum(ms for ms, _ in rows) / sum(n for _, n in rows) if rows else None


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
    from bpt_tpu_torch.kernels import build, megakernel
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

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    megakernel._library()
    phase("build", f"{megakernel.KERNEL} ready in {time.perf_counter() - t0:.2f} s "
                   f"(flags {' '.join(build.NVCC_FLAGS)})")
    log = build.build(megakernel.KERNEL).with_suffix(".so.log")
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
    ms_kernel = cuda_ms(lambda: megakernel.trace_image_fused(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn),
                        iters=50, warmup=5)
    ms_plain = cuda_ms(
        lambda: megakernel.trace_image_fused_reference(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn),
        iters=5, warmup=2)
    ms_frame = cuda_ms(lambda: renderer.render_sample(camera), iters=20, warmup=3)
    rays = SIZE * SIZE * BOUNCES
    lanes = []
    trace_image(scene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, lane_counts=lanes)
    nq, ns = scene.quads.v0.shape[0], scene.spheres.color.shape[0]
    flop, nbytes = kernel_work(lanes, nq, ns, SIZE * SIZE)
    bound_ms, bound_by = bound(flop, nbytes)
    live = [int(c.live) for c in lanes]
    phase("timing", f"{card}: kernel {ms_kernel:.3f} ms/frame ({rays / ms_kernel / 1e3:.1f} Mrays/s), "
                    f"plain {ms_plain:.3f} ms/frame ({rays / ms_plain / 1e3:.1f} Mrays/s), "
                    f"progressive frame through the kernel {ms_frame:.3f} ms "
                    f"({SIZE}x{SIZE}, {BOUNCES} bounces); live lanes per bounce {live}, "
                    f"{flop / 1e9:.4f} GFLOP + {nbytes / 1e6:.3f} MB -> bound {bound_ms:.4f} ms ({bound_by})")

    # ---- 6. grads-mode kernel against its plain version and the forward ---
    grad_err = 0.0
    for mat, tint in ((METAL, False), (TRANSPARENT, False), (TRANSPARENT, True)):
        gscene = cornell_scene(right_sphere_mat=mat, device=dev)
        gcfg = IntegratorConfig(bounces=BOUNCES, transparent_tint=tint)
        got, sg = megakernel.trace_image_fused_grads(gscene, cam, gcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        ref, sg_ref = megakernel.trace_image_fused_grads_reference(gscene, cam, gcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
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
    ms_step = cuda_ms(lambda: bench_step(True), iters=10, warmup=2)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        ms_fwd_step = cuda_ms(lambda: bench_step(False), iters=10, warmup=2)
    bench_rays = SIZE * SIZE * BOUNCES * BENCH_FRAMES
    ms_grad_kernel = cuda_ms(lambda: megakernel.trace_image_fused_grads(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                         RAND_VEC2, bn), iters=50, warmup=5)
    ms_grad_plain = cuda_ms(lambda: megakernel.trace_image_fused_grads_reference(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                                 RAND_VEC2, bn), iters=3, warmup=1)
    dev_fwd = kernel_device_ms(lambda: megakernel.trace_image_fused(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                      RAND_VEC2, bn), 20, "trace_kernel<false, false>")
    dev_grad = kernel_device_ms(lambda: megakernel.trace_image_fused_grads(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                             RAND_VEC2, bn), 20,
                                  "trace_kernel<true, false>")
    qc = bscene.quads.color.clone().requires_grad_(True)
    one = megakernel.trace_image_fused(bscene._replace(quads=bscene.quads._replace(color=qc)), cam, cfg, SIZE, SIZE,
                                       2.0, RAND_VEC2, bn, differentiable=True)
    one_loss = one.color.mean()
    ms_bwd = cuda_ms(lambda: torch.autograd.grad(one_loss, [qc], retain_graph=True), iters=20, warmup=3)
    step_frame[0] = 2.0

    def plain_step():
        lc = bscene.quads.color[5].clone().requires_grad_(True)
        s = bscene._replace(quads=bscene.quads._replace(color=torch.cat([bscene.quads.color[:5], lc[None]])))
        acc = 0.0
        for i in range(BENCH_FRAMES):
            acc = acc + trace_image(s, cam, cfg, GRAD_SIZE, GRAD_SIZE, 2.0 + i, RAND_VEC2, bn).color
        return torch.autograd.grad(acc.mean(), [lc])[0]

    ms_plain_step = cuda_ms(plain_step, iters=2, warmup=1)
    host_ms, busy_ms, rows = profiled_step(lambda: bench_step(True), iters=3)
    top = "; ".join(f"{k[:60]} {ms:.4f} ms x{n:g}" for k, ms, n in rows[:10])
    phase("step-profile", f"{card}: fwd+bwd step under torch.profiler: host {host_ms:.3f} ms, device busy "
                          f"{busy_ms:.3f} ms ({100 * (1 - busy_ms / host_ms):.1f}% idle), {len(rows)} kernels; "
                          f"largest per step: {top}")
    glanes = []
    _, gsg = trace_image(bscene, cam, cfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, param_grads=True, lane_counts=glanes)
    gflop, gbytes = kernel_work(glanes, nq, ns, SIZE * SIZE)
    n_obj = nq + ns
    gflop += gsg[:n_obj].sum().item() + 2 * (gsg[n_obj:] > 0).sum().item()  # the planes' adds
    gbytes += gsg.shape[0] * 4 * SIZE * SIZE
    grad_bound_ms, grad_bound_by = bound(gflop, gbytes)
    plain_rays = GRAD_SIZE * GRAD_SIZE * BOUNCES * BENCH_FRAMES
    phase("grad-timing", f"{card}: {SIZE}x{SIZE}, {BOUNCES} bounces, {BENCH_FRAMES} frames: fwd+bwd step "
                         f"{ms_step:.3f} ms ({bench_rays / ms_step / 1e3:.1f} Mrays/s, peak {peak_gb:.3f} GB), "
                         f"forward-only step {ms_fwd_step:.3f} ms ({bench_rays / ms_fwd_step / 1e3:.1f} Mrays/s); "
                         f"grads kernel {ms_grad_kernel:.3f} ms/launch through its wrapper, device "
                         f"{dev_grad} ms (forward kernel device {dev_fwd} ms); plain grads version "
                         f"{ms_grad_plain:.3f} ms; backward's torch part {ms_bwd:.3f} ms/frame; plain route "
                         f"fwd+bwd step at {GRAD_SIZE}x{GRAD_SIZE} {ms_plain_step:.3f} ms "
                         f"({plain_rays / ms_plain_step / 1e3:.1f} Mrays/s); grads bound: {gflop / 1e9:.4f} GFLOP + "
                         f"{gbytes / 1e6:.3f} MB -> {grad_bound_ms:.4f} ms ({grad_bound_by})")

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
        got, sg = megakernel.trace_image_fused_grads(pscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
        ref, sg_ref = megakernel.trace_image_fused_grads_reference(pscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn)
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

        f_ms = cuda_ms(fwd_call, iters=20, warmup=3)
        g_ms = cuda_ms(grads_call, iters=20, warmup=3)
        f_plain = cuda_ms(lambda: megakernel.trace_image_fused_reference(tscene, fcam, fcfg, SIZE, SIZE, 2.0,
                                                                         RAND_VEC2, bn), iters=2, warmup=1)
        g_plain = cuda_ms(lambda: megakernel.trace_image_fused_grads_reference(tscene, fcam, fcfg, SIZE, SIZE, 2.0,
                                                                               RAND_VEC2, bn), iters=2, warmup=1)
        instance = "true" if fam == "sky" else "false"
        f_dev = kernel_device_ms(fwd_call, 10, f"trace_kernel<false, {instance}>")
        g_dev = kernel_device_ms(grads_call, 10, f"trace_kernel<true, {instance}>")
        f_frame = cuda_ms(lambda: frenderer.render_sample(mcam), iters=10, warmup=2)
        flanes = []
        _, fsg = trace_image(tscene, fcam, fcfg, SIZE, SIZE, 2.0, RAND_VEC2, bn, param_grads=True,
                             lane_counts=flanes)
        n_q = tscene.quads.v0.shape[0]
        n_s = 0 if tscene.spheres is None else tscene.spheres.color.shape[0]
        n_qd = 0 if tscene.quadrics is None else tscene.quadrics.color.shape[0]
        fflop, fbytes = kernel_work(flanes, n_q, n_s, SIZE * SIZE, n_qd, sky=fam == "sky")
        f_bound, f_by = bound(fflop, fbytes)
        n_obj = n_q + n_s + n_qd
        gflop_f = fflop + fsg[:n_obj].sum().item() + 2 * (fsg[n_obj:] > 0).sum().item()
        gbytes_f = fbytes + fsg.shape[0] * 4 * SIZE * SIZE
        g_bound, g_by = bound(gflop_f, gbytes_f)
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
                               f"({g_by})")
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

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
