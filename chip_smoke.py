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

It ends with a JSON line of per-kernel results (each with its bound, the
least time the card could take for the same work), the card's name and
power limit, and a last JSON line {"ok": true, "device": {...}}.
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
# FP32 operations per thread, counted from csrc/cornell_megakernel.cu:
# +, -, *, /, sqrt and each transcendental count one; compares, selects,
# min/max/abs and the integer RNG hash are not counted.
RAYGEN_FLOP = 80  # tent AA, film mapping, thin lens, two normalizations
SPHERE_FLOP = 68  # per sphere per live bounce: transform, quadratic, roots, normal
QUAD_FLOP = 104  # per quad per live bounce: two Moller-Trumbore triangles of 52
HIT_FLOP = 24  # per hit: normal, facing test, hit point (21) + the cheapest branch (3)


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


def kernel_work(lane_counts, n_quads: int, n_spheres: int, pixels: int) -> tuple[float, float]:
    """(FP32 operations, bytes) the forward kernel needs for one frame whose
    plain run reported ``lane_counts`` (live and hit lanes per bounce).  Each
    input byte is read once (the blue-noise table, the packed scene), each
    of the 11 output planes written once.  Sphere normals of closer hits
    and all but the cheapest shading branch are left out, so the operation
    count is a lower bound."""
    live = sum(int(a) for a, _ in lane_counts)
    hits = sum(int(b) for _, b in lane_counts)
    flop = pixels * RAYGEN_FLOP + live * (n_spheres * SPHERE_FLOP + n_quads * QUAD_FLOP) + hits * HIT_FLOP
    nbytes = 256 * 256 * 4 * 4 + 4 * (16 + 20 * n_quads + 21 * n_spheres) + 11 * 4 * pixels
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
    ``name`` while ``fn`` runs; None when the profiler reports none."""
    rows = [(ms, n) for key, ms, n in profiled_step(fn, iters)[2] if name in key]
    return sum(ms for ms, _ in rows) / sum(n for _, n in rows) if rows else None


def main() -> int:
    # ---- 1. device ------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.diff.inverse import optimize, render_avg
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.integrator.frame import trace_image
    from bpt_tpu_torch.kernels import build, megakernel
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
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
    megakernel.LAUNCHES = megakernel.GRAD_LAUNCHES = 0
    img = renderer.render(camera, spp=SPP)
    torch.cuda.synchronize()
    launches, grad_launches = megakernel.LAUNCHES, megakernel.GRAD_LAUNCHES
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
    live = [int(a) for a, _ in lanes]
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

    megakernel.LAUNCHES = megakernel.GRAD_LAUNCHES = 0
    t0 = time.perf_counter()
    target = render_avg(build_scene({"emission": torch.tensor(10.0, device=dev)})[0], cam, tcfg, SIZE,
                        TRAIN_FRAMES, RAND_VEC2, bn)
    result = optimize(build_scene, {"emission": 4.0}, target, tcfg, SIZE, steps=TRAIN_STEPS, lr=0.5,
                      frames=TRAIN_FRAMES)
    losses = result.losses.cpu().numpy()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches, train_grad_launches = megakernel.LAUNCHES, megakernel.GRAD_LAUNCHES
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
                                                                      RAND_VEC2, bn), 20, "cornell_trace_kernel<false>")
    dev_grad = kernel_device_ms(lambda: megakernel.trace_image_fused_grads(bscene, cam, cfg, SIZE, SIZE, 2.0,
                                                                             RAND_VEC2, bn), 20,
                                  "cornell_trace_kernel<true>")
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

    print(json.dumps({"kernels": [{
        "name": "cornell_megakernel",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/cornell_megakernel.cu",
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
        "name": "cornell_megakernel_grads",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/cornell_megakernel.cu",
        "replaces": "bpt_tpu/kernels/megakernel.py:2180",
        "launches": train_grad_launches,
        "max_abs_err": grad_err,
        "ms": ms_grad_kernel,
        "device_ms": dev_grad,
        "plain_ms": ms_grad_plain,
        "bound_ms": grad_bound_ms,
        "bound_by": grad_bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
