"""Demo 4 — a glTF model with its BVH, in the Cornell box.

    python -m bpt_tpu_torch.apps.gltf_model --model teapot --models-dir DIR [--reorder] [--device cpu]

The model presets are the JAX demo's (``apps/gltf_model.py``).  The assets
are not in the repository: ``--models-dir`` names the directory that holds
them, and a missing file fails with its path.  A textured model (duck,
helmet) renders its PBR maps with the metal roughness lobe on
(``metal_roughness_lobe = albedo is not None``, as in the JAX demo);
``--mat`` is the material of an untextured one.
"""

import os

from bpt_tpu_torch.apps.common import base_parser, run_and_save, staged_batches

PRESETS = {
    # name: (file, initial_scale, flip_z (RH -> LH))
    "teapot": ("UtahTeapot.glb", 130.0, True),
    "bunny": ("StanfordBunny.glb", 0.05, True),
    "duck": ("Duck.gltf", 10.0, False),
    "helmet": ("DamagedHelmet.gltf", 15.0, True),
}


def main(argv=None):
    p = base_parser("glTF model path tracer")
    p.add_argument("--model", choices=sorted(PRESETS), default="teapot")
    p.add_argument("--models-dir", default="models", help="directory of the glTF assets")
    p.add_argument("--mat", type=int, default=3, help="model material when untextured")
    p.add_argument("--reorder", action="store_true",
                   help="trace each batch of samples as one staged pool (ray reordering + multi-frame lane pools)")
    args = p.parse_args(argv)

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.io import load_gltf
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    print(f"{args.model}: {model.triangle_count} triangles, textured={model.albedo is not None}")
    mesh = mesh_from_model(model, mat_type=args.mat)
    cfg = IntegratorConfig(bounces=args.bounces, metal_roughness_lobe=model.albedo is not None)
    r = ProgressiveRenderer(gltf_scene(mesh), cfg, args.size, args.size, device=args.device)
    if args.reorder:
        staged_batches(r)
    return run_and_save(r, gltf_camera(), args, f"gltf_{args.model}")


if __name__ == "__main__":
    main()
