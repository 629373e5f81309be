"""Debug demo 7 — the low-resolution / driver-robustness harness.

    python -m bpt_tpu_torch.apps.debug_low_res --model teapot --models-dir DIR [--pixel-resolution 0.1]
        [--mobile] [--device cpu]

The port of the JAX package's ``apps/debug_low_res.py``: the glTF demo at
an internal render scale.  The traced image is ``--size`` times
``--pixel-resolution``, rounded to a multiple of 8 and at least 8 (as the
JAX demo rounds it), and is upscaled to the requested size by nearest
neighbour, as WebGL hardware scaling stretches a low-resolution backbuffer;
``--mobile`` sets the mobile intersection epsilon, ``eps_intersect = 1.0``.
It renders on the card through the megakernel unless ``--device cpu``.  The
assets are not in the repository: ``--models-dir`` names their directory,
and a missing file fails with its path.  The upscaled image is written
beside the traced one as ``<name>_upscaled.png``.
"""

import os

import numpy as np

from bpt_tpu_torch.apps.common import base_parser, run_and_save, save_image

PRESETS = {
    # name: (file, initial_scale, flip_z (RH -> LH))
    "teapot": ("UtahTeapot.glb", 130.0, True),
    "bunny": ("StanfordBunny.glb", 0.05, True),
    "bookcase": ("testBookCase.gltf", 1.0, True),
}


def render_size(size: int, pixel_resolution: float) -> int:
    """The traced size: size x pixel_resolution, rounded to a multiple of 8,
    at least 8."""
    return max(8, int(round(size * pixel_resolution / 8)) * 8)


def upscale(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour upscale of a square (n, n, C) image by the whole
    factor size // n (none below 2)."""
    rep = size // img.shape[0]
    return np.repeat(np.repeat(img, rep, axis=0), rep, axis=1) if rep > 1 else img


def main(argv=None):
    p = base_parser("low-resolution debug harness (pixel_Resolution 0.1)")
    p.add_argument("--model", choices=sorted(PRESETS), default="teapot")
    p.add_argument("--models-dir", default="models", help="directory of the glTF assets")
    p.add_argument("--pixel-resolution", type=float, default=0.1,
                   help="internal render scale (the reference's debug default 0.1)")
    p.add_argument("--mobile", action="store_true", help="mobile fallback: eps_intersect = 1.0")
    p.add_argument("--mat", type=int, default=3, help="model material when untextured")
    args = p.parse_args(argv)

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.io import load_gltf
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    out_size, size = args.size, render_size(args.size, args.pixel_resolution)
    print(f"{args.model}: {model.triangle_count} triangles; rendering {size}x{size} "
          f"(pixel_resolution={args.pixel_resolution}), output {out_size}x{out_size}")
    cfg = IntegratorConfig(bounces=args.bounces, eps_intersect=1.0 if args.mobile else 0.01,
                           metal_roughness_lobe=model.albedo is not None)
    r = ProgressiveRenderer(gltf_scene(mesh_from_model(model, mat_type=args.mat)), cfg, size, size,
                            device=args.device)
    args.size = size  # rays counted at the traced size
    default_name = f"debug_lowres_{args.model}"
    img = upscale(run_and_save(r, gltf_camera(), args, default_name), out_size)
    stem, ext = os.path.splitext(args.out or f"{default_name}.png")
    print(f"wrote {save_image(img, f'{stem}_upscaled{ext}')} ({img.shape[0]}x{img.shape[1]})")
    return img


if __name__ == "__main__":
    main()
