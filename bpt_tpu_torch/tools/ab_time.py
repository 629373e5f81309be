"""Time the Cornell, quadric, sky, mesh, HDRI and textured configurations of
the CUDA kernel in several checkouts of this repository, in turns, on one
card:

    python -m bpt_tpu_torch.tools.ab_time PARENT . . PARENT

Each checkout runs in a process of its own (its own kernel build, from its
own sources) at 1024², 4 bounces, frame 2: the Cornell forward and grads
kernels' device time per launch (torch.profiler, 50 launches), their time
through the wrapper (CUDA events, 50 launches), the progressive frame (CUDA
events, 30 frames), the quadric and sky forward kernels' device time (the
demo scenes, 50 launches each), the mesh and HDRI ones' (bench.py's
524,288-triangle capacity scene from the glTF camera, the HDRI demo on it
with sun and env NEE, 20 launches each), the textured ones' (the checkout's
chip_smoke.textured_stand_in, that mesh with four 2048² maps, from
chip_smoke.py's raised camera: the glTF demo's configuration and the HDRI
demo's with sun and env NEE, the lobe on, 20 launches each), the grads
mode of each mesh, HDRI and textured configuration (20 launches each), the
closest-hit kernel on the capacity mesh's 1024² primary rays from the glTF
camera (50 launches), and the registers and stack nvcc reported for its
builds; with the staged kernel, 8-frame pools (frames 2-9, 4 phases) on the
capacity mesh, its rugged variant, the Cornell box (forward and grads) and
the sky against their 8 K1 launches: the whole pool (CUDA events, 5
pools), K2's phases and the key kernel's two passes (torch.profiler), and
the sort keys and torch.sort of each pool's three boundaries (CUDA events
around each, 3 pools); and in every configuration, forward and grads, the
staged kernel as one phase of one frame (``trace_staged(..., splits=())``:
no sort, no state) against K1 on the same frame, in turns (K1, K2, K2, K1;
25 launches each without a mesh, 10 with one).  A checkout that lacks a
kernel or a grads configuration prints no number for it.  Device times
compare only within one call; put each version more than once, in turns.
"""

from __future__ import annotations

import glob
import subprocess
import sys
from pathlib import Path


def measure(checkout: str) -> None:
    """One checkout, in this process: print one line of numbers."""
    sys.path.insert(0, checkout)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke  # the checkout's own
    from bpt_tpu_torch.camera import Camera
    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import megakernel
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.apps.hdri_environment import synthetic_hdr
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu_torch.scenes.gltf_scene import (gltf_camera, gltf_scene, hdri_camera, hdri_scene, heightfield_model,
                                                 mesh_from_model)
    from bpt_tpu_torch.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene
    from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene, sky_camera

    if not megakernel.__file__.startswith(str(Path(checkout).resolve())):
        raise RuntimeError(f"imported {megakernel.__file__}, not the checkout {checkout}")
    dev, size, rv = torch.device("cuda"), 1024, np.array([0.3, 0.7], np.float32)
    bn = torch.as_tensor(blue_noise_table()).to(dev)
    scene, cam, cfg = cornell_scene(device=dev), cornell_camera(device=dev), IntegratorConfig(bounces=4)

    def fwd():
        return megakernel.trace_image_fused(scene, cam, cfg, size, size, 2.0, rv, bn)

    def grads():
        return megakernel.trace_image_fused_grads(scene, cam, cfg, size, size, 2.0, rv, bn)

    def device_ms(fn, iters=50, kernel="trace_kernel"):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(getattr(ev, "self_device_time_total", 0.0), ev.count) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and kernel in ev.key]
        return sum(us for us, _ in rows) / 1e3 / max(sum(n for _, n in rows), 1)

    def event_ms(fn, iters):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    renderer = ProgressiveRenderer(cornell_scene(), cfg, size, size, device=dev)
    camera = cornell_camera()
    renderer.render(camera, spp=2)
    families = {"quadric": (quadric_geometry_scene(device=dev), quadric_camera(device=dev),
                            IntegratorConfig(bounces=4, transparent_tint=True)),
                "sky": (physical_sky_scene(device=dev), sky_camera(device=dev),
                        IntegratorConfig(bounces=4, env="sky", nee="sun"))}
    numbers = dict(fwd_device_ms=device_ms(fwd), grads_device_ms=device_ms(grads), fwd_wrapper_ms=event_ms(fwd, 50),
                   grads_wrapper_ms=event_ms(grads, 50), frame_ms=event_ms(lambda: renderer.render_sample(camera), 30))
    capacity = mesh_from_model(heightfield_model(), mat_type=1, use_native="require")  # DIFFUSE
    hdri = hdri_scene(capacity, synthetic_hdr(), device=dev)
    hdri_cfg = dict(bounces=4, env="hdri", diffuse_indirect_max=2)
    families.update({
        "mesh": (gltf_scene(capacity, device=dev), gltf_camera(device=dev), IntegratorConfig(bounces=4)),
        "hdri_sun": (hdri, hdri_camera(device=dev),
                     IntegratorConfig(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, **hdri_cfg)),
        "hdri_env": (hdri, hdri_camera(device=dev), IntegratorConfig(nee="env", **hdri_cfg))})
    stand_in = mesh_from_model(chip_smoke.textured_stand_in(heightfield_model()), mat_type=1, use_native="require")
    raised = Camera.look(position=(0.0, 10.0, -70.0), pitch=0.5, fov=0.8, focus_distance=113.0).to(dev)
    textured_hdri = hdri_scene(stand_in, synthetic_hdr(sun_uv=(0.7, 0.7)), device=dev)
    lobe = dict(hdri_cfg, metal_roughness_lobe=True)
    families.update({
        "textured": (gltf_scene(stand_in, device=dev), raised, IntegratorConfig(bounces=4, metal_roughness_lobe=True)),
        "textured_hdri_sun": (textured_hdri, raised,
                              IntegratorConfig(nee="sun", sun_weight_mode="hdri", sun_lobe_roughness=0.03, **lobe)),
        "textured_hdri_env": (textured_hdri, raised, IntegratorConfig(nee="env", **lobe))})
    for name, (fscene, fcam, fcfg) in families.items():
        numbers[f"{name}_fwd_device_ms"] = device_ms(
            lambda: megakernel.trace_image_fused(fscene, fcam, fcfg, size, size, 2.0, rv, bn),
            20 if fscene.mesh is not None else 50)
    if hasattr(megakernel, "compose_deferred"):  # the grads mode of mesh, HDRI and textured scenes came with it
        for name, (fscene, fcam, fcfg) in families.items():
            if fscene.mesh is not None:
                numbers[f"{name}_grads_device_ms"] = device_ms(
                    lambda: megakernel.trace_image_fused_grads(fscene, fcam, fcfg, size, size, 2.0, rv, bn), 20)
    if (Path(checkout) / "bpt_tpu_torch" / "kernels" / "traverse.py").exists():  # the closest-hit kernel
        from bpt_tpu_torch.core.rng import rng_seed
        from bpt_tpu_torch.camera import generate_rays
        from bpt_tpu_torch.core.vecmath import transform_dir, transform_point
        from bpt_tpu_torch.integrator.frame import pixel_grid
        from bpt_tpu_torch.kernels import traverse

        mesh = families["mesh"][0].mesh
        px, py = pixel_grid(size, size, dev)
        ro, rd, _ = generate_rays(gltf_camera(device=dev), px, py, size, size, rng_seed(2.0, px, py))
        ro, rd = transform_point(mesh.inv_matrix, ro), transform_dir(mesh.inv_matrix, rd)
        numbers["closest_hit_device_ms"] = device_ms(lambda: traverse.closest_hit(ro, rd, True, None, mesh), 50,
                                                     "closest_hit_kernel")
    if hasattr(megakernel, "trace_frames_fused"):  # the staged kernel
        from bpt_tpu_torch.kernels import staged

        fcs = [2.0 + i for i in range(8)]
        rvs = [np.array([(i * 0.173) % 1.0, (i * 0.519) % 1.0], np.float32) for i in range(8)]
        rugged = mesh_from_model(heightfield_model(rugged=True), mat_type=1, use_native="require")
        pools = {"mesh": families["mesh"] + (False,),
                 "rugged": (gltf_scene(rugged, device=dev), gltf_camera(device=dev), IntegratorConfig(bounces=4),
                            False),
                 "cornell": (scene, cam, cfg, False), "cornell_grads": (scene, cam, cfg, True),
                 "sky": families["sky"] + (False,)}
        for name, (pscene, pcam, pcfg, pgrads) in pools.items():
            def pool(record=None):
                return staged.trace_staged(pscene, pcam, pcfg, size, size, fcs, rvs, bn, grads=pgrads, record=record)

            def frames():
                k1 = megakernel.trace_image_fused_grads if pgrads else megakernel.trace_image_fused
                return [k1(pscene, pcam, pcfg, size, size, f, rv, bn) for f, rv in zip(fcs, rvs)]

            numbers[f"pool_{name}_ms"] = event_ms(pool, 5)
            numbers[f"pool_{name}_phases_device_ms"] = device_ms(pool, 2, "phase_kernel") * pcfg.bounces
            sums = {"key": 0.0, "sort": 0.0}
            for _ in range(3):
                rec = []
                pool(rec)
                torch.cuda.synchronize()
                for (_, a), (label, b) in zip(rec, rec[1:]):
                    kind = label.split()[0]
                    if kind in sums:
                        sums[kind] += a.elapsed_time(b) / 3
            numbers[f"pool_{name}_keys_ms"] = sums["key"]
            if hasattr(staged, "launch_key"):  # the key kernel: its two passes at each of 3 boundaries
                numbers[f"pool_{name}_keys_device_ms"] = 3 * sum(device_ms(pool, 2, kernel)
                                                                 for kernel in ("key_box_kernel", "key_kernel"))
            numbers[f"pool_{name}_sorts_ms"] = sums["sort"]
            numbers[f"pool_{name}_k1_8_frames_ms"] = event_ms(frames, 5)
        # K2 as one phase of one frame (no sort, no state) against K1 on the same frame, in turns
        for name, (fscene, fcam, fcfg) in {"cornell": (scene, cam, cfg), **families}.items():
            iters = 10 if fscene.mesh is not None else 25
            for grads in (False, True):
                k1 = megakernel.trace_image_fused_grads if grads else megakernel.trace_image_fused

                def one():
                    return k1(fscene, fcam, fcfg, size, size, 2.0, rv, bn)

                def one_phase():
                    return staged.trace_staged(fscene, fcam, fcfg, size, size, [2.0], [rv], bn, splits=(),
                                               grads=grads)

                t = [device_ms(one, iters), device_ms(one_phase, iters, "phase_kernel"),
                     device_ms(one_phase, iters, "phase_kernel"), device_ms(one, iters)]
                mode = "grads" if grads else "fwd"
                numbers[f"one_phase_{name}_{mode}_k1_device_ms"] = (t[0] + t[3]) / 2
                numbers[f"one_phase_{name}_{mode}_k2_device_ms"] = (t[1] + t[2]) / 2
    build = []
    for log in glob.glob(str(Path(checkout) / "bpt_tpu_torch" / "_build" / "*.log")):
        build += [line.strip() for line in open(log) if "registers" in line or "stack frame" in line]
    print(f"{checkout}: " + " ".join(f"{k} {v:.4f}" for k, v in numbers.items())
          + (f" | build: {'; '.join(build)}" if build else ""), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        measure(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for checkout in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", str(Path(checkout).resolve())],
                              capture_output=True, text=True)
        print(proc.stdout.strip(), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
