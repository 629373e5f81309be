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
camera and on bounce 2's rays and lane mask in a plain wavefront pass
(``bounce_rays``, as ``chip_smoke.py`` builds them; 50 launches each), and
the registers and stack nvcc reported for its builds; with the staged
kernel, 8-frame pools (frames 2-9, 4 phases) on the
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

    python -m bpt_tpu_torch.tools.ab_time --only closest_hit A B B A

times the closest-hit kernel alone (its two ray sets), for the checkouts
that differ only in it.

    python -m bpt_tpu_torch.tools.ab_time --only nomesh PARENT . V1 V2 V2 V1 . PARENT

times K1's six configurations without a mesh (Cornell, quadric and sky,
forward and grads: device ms per launch at 1024², 4 bounces, frame 2, 50
launches each), K2's 8-frame Cornell and sky pools (the phases' device ms
and the pool's CUDA-event ms) and, for bench.py's Cornell fwd+bwd step
(1024², 4 bounces, 8 frames, w.r.t. the light's color), its device
operations and host synchronizations (``step_counts``), with ptxas's
registers and spills per no-mesh instantiation.  The variants of the
kernels' design that were measured and not kept are checkouts of this
tree made by a patch or a one-line edit, run from the repository's root:

    v() { mkdir -p _scratch/$1 && git archive HEAD | tar -x -C _scratch/$1; }
    p() { patch -d _scratch/$1 -p1 < bpt_tpu_torch/tools/ab_variants/$2.patch; }
    v scene_scalar && p scene_scalar scene_scalar
    v scene_constant_bank && p scene_constant_bank scene_scalar && p scene_constant_bank scene_constant_bank
    v k1_bound_3 && sed -i 's/(256, 4) trace_kernel/(256, 3) trace_kernel/' \
        _scratch/k1_bound_3/bpt_tpu_torch/csrc/megakernel.cu
    v k1_no_bound && sed -i 's/__launch_bounds__(256, 4) trace_kernel/trace_kernel/' \
        _scratch/k1_no_bound/bpt_tpu_torch/csrc/megakernel.cu
    v k2_bound_4 && sed -i 's/(256, 3) phase_kernel/(256, 4) phase_kernel/' \
        _scratch/k2_bound_4/bpt_tpu_torch/csrc/staged.cu

    python -m bpt_tpu_torch.tools.ab_time --only textured PARENT . V1 V1 . PARENT

times the textured configurations (the checkout's
chip_smoke.textured_stand_in, four 2048² maps, from chip_smoke.py's raised
camera at 1024², 4 bounces, frame 2): K1's glTF, HDRI sun and HDRI env
configurations, forward and grads (device ms per launch, 20 launches
each); K2's 8-frame pool of the glTF configuration, forward and grads (the
phases' device ms, and the pool's CUDA-event ms); as controls the same
mesh and view untextured, forward and grads, and its 8-frame K2 pool; and
the registers and spills of every textured instantiation of K1 and K2 with
a digest of the SASS of every other instantiation (``cuobjdump -sass``),
which shows whether the untextured kernels compiled to the same code.  The
variants of the texel path that were measured and not kept:

    v texel_interleaved && p texel_interleaved texel_interleaved
    v texel_per_map && p texel_per_map texel_interleaved && p texel_per_map texel_per_map
    v texel_quad_interleaved && p texel_quad_interleaved texel_interleaved \
        && p texel_quad_interleaved texel_quad_interleaved
    v texel_ungated && p texel_ungated texel_ungated
    v texel_batched && p texel_batched texel_batched
    v tex_bound_3 && sed -i 's/(256, 4) \\(trace\\|phase\\)_kernel_textured/(256, 3) \\1_kernel_textured/' \
        _scratch/tex_bound_3/bpt_tpu_torch/csrc/megakernel.cu _scratch/tex_bound_3/bpt_tpu_torch/csrc/staged.cu

(tex_no_bound likewise with the bound taken out).  texel_interleaved
interleaves the maps of one size into one record per texel, a 16-byte
slot each (the record's length a field of the argument block: the untextured
K2 instantiations' argument offsets move); on top of it texel_per_map gives
each map a table of 16-byte texels of its own, and texel_quad_interleaved
interleaves the maps' quad records; texel_ungated samples the normal map on
shadow rays and the emissive map on every PBR hit; texel_batched loads
every tap of a PBR hit before the first combine.

scene_scalar reads the scene block from shared memory by scalar loads
(the parameter pack and the sphere rows without their 16-byte pads);
scene_constant_bank, on top of it, reads the block from a ``__constant__``
bank filled by a device-to-device copy on the launch's stream before each
launch; the other three change a register bound.

    python -m bpt_tpu_torch.tools.ab_time --only loop_cost PARENT . V1 V1 . PARENT

times K5's seven configurations: ns/iter by CUDA events and device ms a
launch by the profiler, 5 launches of 4000 iterations each (the tool's
default), with each checkout's mapping (blocks of the cluster x tile
values a thread; a checkout from before the cluster, one block x 8),
ptxas's registers for each instantiation and a digest of the SASS of the
other four libraries (K1, K2, the sort key, K3).  The mappings measured
and not kept: every configuration on 1, 2, 4 or 8 blocks, and the vote
through a cluster barrier a trip instead of iteration-tagged words:

    for n in 1 2 4 8; do v loop_cost_cluster$n && p loop_cost_cluster$n loop_cost_cluster$n; done
    v loop_cost_barrier && p loop_cost_barrier loop_cost_barrier \
        && p loop_cost_barrier loop_cost_cluster8

(copy the other four libraries of ``_build/`` into each such checkout to
spare their builds: same sources, same hashes).
"""

from __future__ import annotations

import glob
import re
import subprocess
import sys
from pathlib import Path


LOOP_ITERS = 4000  # K5's iterations a launch, the tool's default


def bounce_rays(scene, cam, cfg, size: int, rand_vec2, bn, bounce: int) -> tuple:
    """The object-space rays (size, size, 3) and the live-lane mask that
    bounce ``bounce`` of a plain wavefront pass at frame 2 hands the mesh's
    walk (the plain walk's own arguments)."""
    from bpt_tpu_torch.accel import traverse as accel_traverse
    from bpt_tpu_torch.integrator.frame import trace_image

    seen = []
    walk = accel_traverse.traverse_bvh

    def spy(*args, **kw):
        seen.append((args[7], args[8], kw.get("active")))
        return walk(*args, **kw)

    accel_traverse.traverse_bvh = spy
    try:
        trace_image(scene, cam, cfg, size, size, 2.0, rand_vec2, bn, plain_walk=True)
    finally:
        accel_traverse.traverse_bvh = walk
    return seen[bounce]


def step_counts(fn, tries: int = 3) -> tuple[int, int]:
    """(device operations, host synchronizations) of one call of ``fn``
    after a warm call: the kernels, copies and memsets torch.profiler
    records on the card, and the synchronizing calls torch's sync debug mode
    reports (a copy to the host, ``.item()``, a blocking copy from pageable
    memory).  A profiler session that records no device activity is run
    again, up to ``tries`` sessions."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ops = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
        if ops:
            break
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return ops, sum("synchroniz" in str(w.message) for w in caught)


def cornell_step(megakernel, scene, cam, cfg, size: int, frames: int, bn, rv):
    """bench.py's default cell as one call: ``frames`` frames of the
    Cornell box through ``trace_image_fused(differentiable=True)``, the
    mean of their colors, its gradient w.r.t. the light's (quad 5) color."""
    import torch

    def step():
        lc = scene.quads.color[5].clone().requires_grad_(True)
        s = scene._replace(quads=scene.quads._replace(color=torch.cat([scene.quads.color[:5], lc[None]])))
        acc = 0.0
        for i in range(frames):
            acc = acc + megakernel.trace_image_fused(s, cam, cfg, size, size, 2.0 + i, rv, bn,
                                                     differentiable=True).color
        return torch.autograd.grad(acc.mean(), [lc])[0]

    return step


def measure(checkout: str, only: str | None = None) -> None:
    """One checkout, in this process: print one line of numbers (``only``
    "closest_hit": the closest-hit kernel's alone; "nomesh": K1 without a
    mesh, K2's Cornell and sky pools and the Cornell step's counts;
    "textured": the textured configurations; "loop_cost": K5's seven
    configurations)."""
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

    def event_ms(fn, iters):  # utils.profiling.event_ms, which a checkout measured here may predate
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

    def closest_hit_ms(model) -> dict:
        """The closest-hit kernel's device ms on the capacity mesh's primary
        rays from the glTF camera and on bounce 2's rays and mask."""
        from bpt_tpu_torch.camera import generate_rays
        from bpt_tpu_torch.core.rng import rng_seed
        from bpt_tpu_torch.core.vecmath import transform_dir, transform_point
        from bpt_tpu_torch.integrator.frame import pixel_grid
        from bpt_tpu_torch.kernels import traverse

        mscene, mcam = gltf_scene(model, device=dev), gltf_camera(device=dev)
        mesh = mscene.mesh
        px, py = pixel_grid(size, size, dev)
        ro, rd, _ = generate_rays(mcam, px, py, size, size, rng_seed(2.0, px, py))
        ro, rd = transform_point(mesh.inv_matrix, ro), transform_dir(mesh.inv_matrix, rd)
        ro_b, rd_b, act_b = bounce_rays(mscene, mcam, IntegratorConfig(bounces=4), size, rv, bn, 2)
        return {"closest_hit_device_ms": device_ms(lambda: traverse.closest_hit(ro, rd, True, None, mesh), 50,
                                                   "closest_hit_kernel"),
                "closest_hit_bounce2_device_ms": device_ms(lambda: traverse.closest_hit(ro_b, rd_b, True, act_b, mesh),
                                                           50, "closest_hit_kernel")}

    def nomesh_numbers() -> dict:
        """K1's six configurations without a mesh, K2's Cornell and sky
        pools, and the Cornell fwd+bwd step's device operations and host
        synchronizations."""
        from bpt_tpu_torch.kernels import staged

        numbers = {}
        cases = {"cornell": (scene, cam, cfg),
                 "quadric": (quadric_geometry_scene(device=dev), quadric_camera(device=dev),
                             IntegratorConfig(bounces=4, transparent_tint=True)),
                 "sky": (physical_sky_scene(device=dev), sky_camera(device=dev),
                         IntegratorConfig(bounces=4, env="sky", nee="sun"))}
        for name, (fscene, fcam, fcfg) in cases.items():
            for mode, k1 in (("fwd", megakernel.trace_image_fused), ("grads", megakernel.trace_image_fused_grads)):
                numbers[f"{name}_{mode}_device_ms"] = device_ms(
                    lambda: k1(fscene, fcam, fcfg, size, size, 2.0, rv, bn), 50)
        fcs = [2.0 + i for i in range(8)]
        rvs = [np.array([(i * 0.173) % 1.0, (i * 0.519) % 1.0], np.float32) for i in range(8)]
        for name in ("cornell", "sky"):
            pscene, pcam, pcfg = cases[name]

            def pool():
                return staged.trace_staged(pscene, pcam, pcfg, size, size, fcs, rvs, bn)

            numbers[f"pool_{name}_phases_device_ms"] = device_ms(pool, 2, "phase_kernel") * pcfg.bounces
            numbers[f"pool_{name}_ms"] = event_ms(pool, 5)
        ops, syncs = step_counts(cornell_step(megakernel, scene, cam, cfg, size, 8, bn, rv))
        numbers["step_device_ops"], numbers["step_host_syncs"] = ops, syncs
        return numbers

    def textured_numbers() -> dict:
        """K1's textured configurations forward and grads, K2's 8-frame
        textured pools, and the same mesh and view untextured."""
        from bpt_tpu_torch.kernels import staged

        stand_in = mesh_from_model(chip_smoke.textured_stand_in(heightfield_model()), mat_type=1,
                                   use_native="require")
        raised = Camera.look(position=(0.0, 10.0, -70.0), pitch=0.5, fov=0.8, focus_distance=113.0).to(dev)
        hdri_scene_ = hdri_scene(stand_in, synthetic_hdr(sun_uv=(0.7, 0.7)), device=dev)
        lobe = dict(bounces=4, env="hdri", diffuse_indirect_max=2, metal_roughness_lobe=True)
        gltf = gltf_scene(stand_in, device=dev)
        bare = gltf._replace(mesh=gltf.mesh._replace(albedo=None, normal_map=None, metallic_roughness=None,
                                                     emissive=None))
        cases = {"textured": (gltf, IntegratorConfig(bounces=4, metal_roughness_lobe=True)),
                 "textured_hdri_sun": (hdri_scene_, IntegratorConfig(nee="sun", sun_weight_mode="hdri",
                                                                     sun_lobe_roughness=0.03, **lobe)),
                 "textured_hdri_env": (hdri_scene_, IntegratorConfig(nee="env", **lobe)),
                 "untextured": (bare, IntegratorConfig(bounces=4))}
        numbers = {}
        for name, (fscene, fcfg) in cases.items():
            for mode, k1 in (("fwd", megakernel.trace_image_fused), ("grads", megakernel.trace_image_fused_grads)):
                numbers[f"{name}_{mode}_device_ms"] = device_ms(
                    lambda: k1(fscene, raised, fcfg, size, size, 2.0, rv, bn), 20)
        fcs = [2.0 + i for i in range(8)]
        rvs = [np.array([(i * 0.173) % 1.0, (i * 0.519) % 1.0], np.float32) for i in range(8)]
        for name, pscene, pcfg, pgrads in (("textured", gltf, cases["textured"][1], False),
                                          ("textured_grads", gltf, cases["textured"][1], True),
                                          ("untextured", bare, cases["untextured"][1], False)):
            def pool():
                return staged.trace_staged(pscene, raised, pcfg, size, size, fcs, rvs, bn, grads=pgrads)

            numbers[f"pool_{name}_phases_device_ms"] = device_ms(pool, 2, "phase_kernel") * pcfg.bounces
            numbers[f"pool_{name}_ms"] = event_ms(pool, 3)
        return numbers

    if only == "loop_cost":
        from bpt_tpu_torch.kernels import build
        from bpt_tpu_torch.kernels import loop_cost as k5
        from bpt_tpu_torch.tools import loop_cost as tool

        tab, x = torch.from_numpy(tool.table()).to(dev), torch.from_numpy(tool.tile_input(0)).to(dev)
        numbers, mappings = {}, []
        for config in k5.CONFIGS:
            n_ops, red, cond = config
            name = f"ops{n_ops}_r{int(red)}_c{int(cond)}"

            def launch():
                return k5.loop_cost(tab, x, LOOP_ITERS, *config)

            numbers[f"{name}_ns_per_iter"] = event_ms(launch, 5) * 1e6 / LOOP_ITERS
            numbers[f"{name}_device_ms"] = device_ms(
                launch, 5, f"loop_cost_kernel<{n_ops}, {str(red).lower()}, {str(cond).lower()}")
            mapping = getattr(k5, "mapping", None)  # a checkout before the cluster mapping: one block
            cluster, values = mapping(config) if mapping else (1, 8)
            mappings.append(f"{name} {cluster}x{values}")
        print_numbers(checkout, numbers, [])
        log = Path(f"{build.build(k5.KERNEL)}.log").read_text().splitlines()
        entry = re.compile(r"loop_cost_kernelILi(\d+)ELb([01])ELb([01])E(?:Li(\d)E)?")
        ptxas = [("<" + ",".join(g for g in entry.search(line).groups() if g) + ">") if "Compiling entry" in line
                 else line.split(":", 1)[-1].strip() for line in log if "Compiling entry" in line or "Used" in line]
        others = [build.build(name) for name in ("megakernel", "staged", "sort_key", "closest_hit")]
        print(f"{checkout}: mapping (blocks x values a thread): {', '.join(mappings)}; ptxas: {' '.join(ptxas)}; "
              f"sass of the other kernels: {sass_digests(others)}", flush=True)
        return
    if only == "closest_hit":
        numbers = closest_hit_ms(mesh_from_model(heightfield_model(), mat_type=1, use_native="require"))
        print_numbers(checkout, numbers)
        return
    if only == "nomesh":
        numbers = nomesh_numbers()
        from bpt_tpu_torch.kernels import build

        logs = [f"{build.build(name)}.log" for name in ("megakernel", "staged")]
        print_numbers(checkout, numbers, logs)
        return
    if only == "textured":
        numbers = textured_numbers()
        from bpt_tpu_torch.kernels import build

        libs = [build.build(name) for name in ("megakernel", "staged")]
        print_numbers(checkout, numbers, [f"{lib}.log" for lib in libs], textured=True)
        print(f"{checkout}: sass of the other instantiations: {sass_digests(libs)}", flush=True)
        return
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
        numbers.update(closest_hit_ms(capacity))
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
    print_numbers(checkout, numbers)


def ptxas_report(log: str, textured: bool = False) -> list[str]:
    """The no-mesh instantiations of K1 (``trace_kernel``) and K2
    (``phase_kernel``) in a build log of nvcc -Xptxas -v, one string each:
    "trace_kernel<grads,env,nee>: N registers, F B stack, S/L B spill
    stores/loads"; with ``textured`` the textured ones instead (the parent
    of the texel table named them ``trace_kernel<grads,env,nee,true>``)."""
    import re

    if textured:
        entry = re.compile(r"Compiling entry function '\w*?(trace_kernel_textured|phase_kernel_textured|trace_kernel|"
                           r"phase_kernel)ILb([01])ELi(\d)ELi(\d)E(?:Lb1E)?EEvN")
        keep = re.compile(r"_texturedI|Lb1EEEvN")
    else:
        entry = re.compile(r"Compiling entry function '\w*?(trace_kernel|phase_kernel)ILb([01])ELi(\d)ELi(\d)EEEv")
        keep = re.compile(".")
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = entry.search(line)
        if "Compiling entry function" in line:
            name = f"{m.group(1)}<{m.group(2)},{m.group(3)},{m.group(4)}>" if m and keep.search(line) else None
            spill = ""
        elif name and "stack frame" in line:
            frame, stores, loads = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                                             r"loads", line).groups()
            spill = f", {frame} B stack, {stores}/{loads} B spill stores/loads"
        elif name and "Used" in line and "registers" in line:
            out.append(f"{name}: {re.search(r'Used (\d+) registers', line).group(1)} registers{spill}")
            name = None
    return out


def sass_digests(libs) -> str:
    """A digest of each library's SASS (``cuobjdump -sass``) over every
    function but the textured instantiations of K1 and K2, and the number
    of those functions: equal digests in two checkouts mean the same code.
    The instructions are read without their encodings, and the addresses of
    the module's constants (bank 4, laid out over every function of the
    library) and the file hash in the names are masked."""
    import hashlib
    import re

    out = []
    for lib in libs:
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        sass = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", sass)
        sass = re.sub(r"c\[0x4\]\[0x[0-9a-f]+\]", "c[0x4][*]", sass)
        sass = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+", r"_GLOBAL__N_\1", sass)
        functions = re.split(r"\n\s*Function : ", sass)[1:]
        kept = sorted(f for f in functions if not re.match(r"\S*(_texturedI|Lb1EEEvN)", f))
        out.append(f"{Path(lib).name.split('-')[0]} {len(kept)} functions "
                   f"{hashlib.sha256(''.join(kept).encode()).hexdigest()[:16]}")
    return "; ".join(out)


def print_numbers(checkout: str, numbers: dict, logs=None, textured: bool = False) -> None:
    """One line: the checkout, its numbers, and what nvcc reported for its
    builds (registers, shared memory, stack, spills): every line of the
    checkout's build logs, or with ``logs`` the no-mesh instantiations of
    those logs (``ptxas_report``; the textured ones with ``textured``)."""
    build = []
    if logs is None:
        for log in sorted(glob.glob(str(Path(checkout) / "bpt_tpu_torch" / "_build" / "*.log"))):
            build += [line.strip() for line in open(log) if "registers" in line or "stack frame" in line]
    else:
        for log in logs:
            build += ptxas_report(Path(log).read_text(), textured)
    print(f"{checkout}: " + " ".join(f"{k} {v:.4f}" for k, v in numbers.items())
          + (f" | build: {'; '.join(build)}" if build else ""), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        measure(argv[1], argv[2] if len(argv) > 2 else None)
        return 0
    only = None
    if argv[:1] == ["--only"]:
        if argv[1] not in ("closest_hit", "nomesh", "textured", "loop_cost"):
            print("--only takes closest_hit, nomesh, textured or loop_cost", file=sys.stderr)
            return 2
        only, argv = argv[1], argv[2:]
    if not argv:
        print(__doc__)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for checkout in argv:
        cmd = [sys.executable, __file__, "--one", str(Path(checkout).resolve())] + ([only] if only else [])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        print(proc.stdout.strip(), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
