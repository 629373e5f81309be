"""Fused-kernel against wavefront fidelity on a glTF asset (port of
``tools/fidelity.py``).

    python -m bpt_tpu_torch.tools.fidelity --model helmet --models-dir DIR [--size 256] [--bounces 4]
        [--device cpu]

One frame with fixed draws (frame 2, offsets (0.3, 0.7)) through the
fused route, ``trace_image_fused`` (the megakernel on the card), and the
wavefront, ``trace_image`` (the closest-hit kernel walks the mesh on the
card); both take the same quad test (``fast_quads=None``, decided per
quad geometry).  Both consume the same random draws, so what differs is the
two routes' arithmetic: the share of pixels whose colour differs by more
than 1e-3, split into small smooth differences (at most 0.05, "bake-scale"
in the JAX tool's words) and path flips (a float tie sent the path another
way: another Monte Carlo sample, not a bias), and the mean and largest
difference.

The JAX tool's ``--split-normals``, ``--deg``, ``--split-mixed`` and
``--no-woop`` are not ported: they select the TPU kernel's per-triangle
decision bake, its per-vertex normal-map bake and its Woop triangle tester,
which the CUDA kernel does not have (it fetches each lane's texels itself
and tests triangles as the wavefront does).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

PRESETS = {
    # name: (file, initial_scale, flip_z (RH -> LH)): the JAX tool's
    "teapot": ("UtahTeapot.glb", 130.0, True),
    "duck": ("Duck.gltf", 10.0, False),
    "helmet": ("DamagedHelmet.gltf", 15.0, True),
}
RAND_VEC2 = np.array([0.3, 0.7], np.float32)


def fidelity(scene, camera, cfg, size: int, blue_noise: torch.Tensor, frame_counter: float = 2.0,
             rand_vec2=RAND_VEC2) -> dict:
    """The fused route against the wavefront on one size x size frame, on
    the device of ``blue_noise``: the percentages of pixels whose largest
    channel difference is above 1e-3 (``pct``), of those at most 0.05
    (``bake_pct``) and above 0.05 (``flip_pct``), and the ``mean`` and
    ``max`` difference."""
    from bpt_tpu_torch.integrator.frame import trace_image
    from bpt_tpu_torch.kernels.megakernel import trace_image_fused

    fused = trace_image_fused(scene, camera, cfg, size, size, frame_counter, rand_vec2, blue_noise).color
    ref = trace_image(scene, camera, cfg, size, size, frame_counter, rand_vec2, blue_noise, fast_quads=None).color
    d = (fused - ref).abs().amax(-1).double()
    off = d > 1e-3
    return {"pct": 100.0 * off.double().mean().item(), "bake_pct": 100.0 * (off & (d <= 0.05)).double().mean().item(),
            "flip_pct": 100.0 * (d > 0.05).double().mean().item(), "mean": d.mean().item(), "max": d.max().item()}


def line(name: str, size: int, bounces: int, triangles: int, f: dict) -> str:
    """The JAX tool's report line."""
    return (f"{name} {size}x{size} b={bounces} tris={triangles}: {f['pct']:.2f}% pixels >1e-3 "
            f"[{f['bake_pct']:.2f}% bake-scale <=0.05, {f['flip_pct']:.2f}% path flips], "
            f"mean |d| {f['mean']:.5f}, max {f['max']:.4f}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=sorted(PRESETS), default="helmet")
    ap.add_argument("--models-dir", default="models", help="directory of the glTF assets")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu runs both routes' plain versions; default: the card")
    args = ap.parse_args(argv)

    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.device import default_device
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.io import load_gltf
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    device = default_device(args.device)
    scene = gltf_scene(mesh_from_model(model, mat_type=3), device=device)
    cfg = IntegratorConfig(bounces=args.bounces, metal_roughness_lobe=model.albedo is not None)
    bn = torch.as_tensor(blue_noise_table()).to(device)
    f = fidelity(scene, gltf_camera(device=device), cfg, args.size, bn)
    print(line(args.model, args.size, args.bounces, model.triangle_count, f))
    return f


if __name__ == "__main__":
    main()
