"""Demo 5 — an HDRI environment around a glTF model.

    python -m bpt_tpu_torch.apps.hdri_environment --model duck --models-dir DIR [--nee env] [--reorder] [--device cpu]

The flags are the JAX demo's (``apps/hdri_environment.py``).  ``--hdr``
takes any equirect Radiance file; without one a procedural sky with a sun
(``synthetic_hdr``) lights the scene.  The glTF assets are not in the
repository (a missing file fails with its path).  The default model, duck,
is textured: its PBR maps render with the metal roughness lobe on.
"""

import os

import numpy as np

from bpt_tpu_torch.apps.common import base_parser, run_and_save, staged_batches


def synthetic_hdr(h=256, w=512, sun_uv=(0.7, 0.3), sun_power=40.0):
    """Equirect gradient sky + bright sun disc (a stand-in for HDR assets)."""
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    v /= h
    u /= w
    sky = np.stack(
        [0.2 + 0.3 * (1 - v), 0.35 + 0.4 * (1 - v), 0.7 + 0.3 * (1 - v)], axis=-1
    )
    d2 = ((u - sun_uv[0]) * 2) ** 2 + (v - sun_uv[1]) ** 2
    sun = np.exp(-d2 * 4000.0)[..., None] * np.array([1.0, 0.95, 0.8]) * sun_power
    return (sky + sun).astype(np.float32)


def main(argv=None):
    from bpt_tpu_torch.apps.gltf_model import PRESETS

    p = base_parser("HDRI environment path tracer")
    p.add_argument("--nee", choices=("sun", "env"), default="sun",
                   help="'sun' = the sun-lobe NEE; 'env' = luminance-CDF importance sampling of the map")
    p.add_argument("--model", default="duck")
    p.add_argument("--models-dir", default="models", help="directory of the glTF assets")
    p.add_argument("--hdr", default=None, help="path to an equirect .hdr")
    p.add_argument("--hdr-exposure", type=float, default=1.0)
    p.add_argument("--sun-power", type=float, default=4.0)
    p.add_argument("--reorder", action="store_true",
                   help="trace each batch of samples as one staged pool (ray reordering + multi-frame lane pools)")
    args = p.parse_args(argv)

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.io import load_gltf, read_hdr
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.gltf_scene import hdri_camera, hdri_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    mesh = mesh_from_model(model, mat_type=3)
    hdr = read_hdr(args.hdr) if args.hdr else synthetic_hdr()
    scene = hdri_scene(mesh, hdr, hdr_exposure=args.hdr_exposure, sun_power=args.sun_power)
    cfg = IntegratorConfig(
        bounces=args.bounces, env="hdri", nee=args.nee, sun_weight_mode="hdri",
        sun_lobe_roughness=0.03, diffuse_indirect_max=2,
        metal_roughness_lobe=model.albedo is not None,
    )
    r = ProgressiveRenderer(scene, cfg, args.size, args.size, device=args.device)
    if args.reorder:
        staged_batches(r)
    return run_and_save(r, hdri_camera(), args, f"hdri_{args.model}")


if __name__ == "__main__":
    main()
