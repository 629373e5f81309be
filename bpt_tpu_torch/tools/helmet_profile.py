"""Decompose the staged pool's cost on a glTF asset (port of
``tools/helmet_profile.py``).

    python -m bpt_tpu_torch.tools.helmet_profile --model helmet --models-dir DIR [--size 512] [--frames 8]

The JAX tool's variants, each an F-frame pool of ``trace_frames_fused``
(K2 and its key kernel on the card) unless named monolithic:
  * bounces 1, 2 and 4 with a sort before every bounce (the bounce slope);
  * 4 bounces unsorted (one phase: the sort's and the phase boundary's
    cost), and sorted before bounce 1 only and before bounces 1 and 2;
  * the monolithic route: F launches of ``trace_image_fused`` (K1).
Each is timed with CUDA events (``utils.profiling.event_ms``) after a
warm-up call, and reported in ms and Mrays/s (F·size²·bounces rays).  The
JAX tool's ``--leaf-size`` and ``sub_rows`` variant set its packet walk's
leaf size and its mesh streaming's row blocks, which the CUDA walk (one
triangle a leaf, the tables in device memory) does not have.
``profile`` takes any scene; with no asset, the CLI fails naming the
missing path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from bpt_tpu_torch.tools.fidelity import PRESETS


def profile(scene, camera, size: int, frames: int, blue_noise: torch.Tensor, lobe: bool = False,
            iters: int = 3) -> list[dict]:
    """Time the variants on ``scene`` at size x size, ``frames`` frames a
    pool, on the device of ``blue_noise``: one dict per variant (``name``,
    ``ms`` per pool, ``mrays`` per second), each printed as it is timed."""
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels.megakernel import trace_frames_fused, trace_image_fused
    from bpt_tpu_torch.utils.profiling import event_ms

    counters = [2.0 + f for f in range(frames)]
    rvs = [np.array([0.3, 0.7], np.float32)] * frames
    device = blue_noise.device

    def staged(bounces, splits):
        cfg = IntegratorConfig(bounces=bounces, metal_roughness_lobe=lobe)
        return lambda: trace_frames_fused(scene, camera, cfg, size, size, counters, rvs, blue_noise,
                                          reorder_splits=splits)

    def monolithic():
        cfg = IntegratorConfig(bounces=4, metal_roughness_lobe=lobe)
        for fc, rv in zip(counters, rvs):
            trace_image_fused(scene, camera, cfg, size, size, fc, rv, blue_noise)

    variants = [(f"staged b={b} full splits", b, staged(b, tuple(range(1, b)))) for b in (1, 2, 4)]
    variants += [("staged b=4 NO reorder (splits=())", 4, staged(4, ())),
                 ("staged b=4 splits=(1,)", 4, staged(4, (1,))),
                 ("staged b=4 splits=(1,2)", 4, staged(4, (1, 2))),
                 (f"monolithic x{frames} b=4", 4, monolithic)]
    rows = []
    for name, bounces, fn in variants:
        ms = event_ms(fn, iters=iters, warmup=1, device=device)
        mrays = frames * size * size * bounces / ms / 1e3
        print(f"{name:44s} {ms:9.1f} ms\n    -> {mrays:8.1f} Mrays/s", flush=True)
        rows.append({"name": name, "ms": ms, "mrays": mrays})
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--model", choices=sorted(PRESETS), default="helmet")
    ap.add_argument("--models-dir", default="models", help="directory of the glTF assets")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default=None, help="cpu runs the plain versions (slow); default: the card")
    args = ap.parse_args(argv)

    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.device import default_device
    from bpt_tpu_torch.io import load_gltf
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    device = default_device(args.device)
    scene = gltf_scene(mesh_from_model(model, mat_type=3), device=device)
    bn = torch.as_tensor(blue_noise_table()).to(device)
    print(f"{args.model}: {model.triangle_count} triangles, {args.size}x{args.size}, {args.frames} frames a pool")
    return profile(scene, gltf_camera(device=device), args.size, args.frames, bn, lobe=model.albedo is not None,
                   iters=args.iters)


if __name__ == "__main__":
    main()
