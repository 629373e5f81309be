"""Debug demo 6 — the multi-mesh, multi-material glTF loading harness.

    python -m bpt_tpu_torch.apps.debug_gltf_loading --model bookcase --models-dir DIR [--material-index 3]
        [--dump-only] [--device cpu]

The port of the JAX package's ``apps/debug_gltf_loading.py``: it prints the
asset's meshes and materials (``io.describe_gltf``), then renders the merged
model with one material's texture set shared by the whole model
(``load_gltf(material_index=...)``), translated to z = 22 in the glTF
demo's Cornell box.  The assets are not in the repository: ``--models-dir``
names their directory, and a missing file fails with its path.
"""

import os

from bpt_tpu_torch.apps import gltf_model
from bpt_tpu_torch.apps.common import base_parser, run_and_save

PRESETS = {
    # name: (file, initial_scale, flip_z (RH -> LH)): the debug page's fixtures and the glTF demo's models
    "bookcase": ("testBookCase.gltf", 1.0, True),
    "twoparts": ("twoParts-opaque.gltf", 10.0, True),
    **gltf_model.PRESETS,
}


def main(argv=None):
    p = base_parser("glTF loading debug harness (multi-mesh, multi-material)")
    p.add_argument("--model", choices=sorted(PRESETS), default="bookcase")
    p.add_argument("--models-dir", default="models", help="directory of the glTF assets")
    p.add_argument("--material-index", type=int, default=None,
                   help="share this material's texture set across the whole merged model")
    p.add_argument("--translate-z", type=float, default=22.0, help="model translation in z")
    p.add_argument("--mat", type=int, default=1, help="model material when untextured")
    p.add_argument("--dump-only", action="store_true", help="print the asset's description and exit")
    args = p.parse_args(argv)

    from bpt_tpu_torch.io import describe_gltf, load_gltf

    name, scale, flip = PRESETS[args.model]
    path = os.path.join(args.models_dir, name)
    info = describe_gltf(path)
    print(f"{path}: {len(info['meshes'])} meshes, {len(info['materials'])} materials, {info['nodes']} nodes, "
          f"images={info['images']}")
    for i, mat in enumerate(info["materials"]):
        print(f"  material[{i}] {mat['name']}: baseColorTex={mat['baseColorTexture']} "
              f"factor={mat['baseColorFactor']} metal={mat['metallicFactor']} rough={mat['roughnessFactor']} "
              f"doubleSided={mat['doubleSided']}")
    for i, mesh in enumerate(info["meshes"][:8]):
        print(f"  mesh[{i}] {mesh['name']}: {mesh['primitives']}")
    if len(info["meshes"]) > 8:
        print(f"  ... {len(info['meshes']) - 8} more meshes")
    if args.dump_only:
        return info

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    model = load_gltf(path, initial_scale=scale, flip_z=flip, material_index=args.material_index)
    missing_uv = bool((model.uv0 < 0).all()) if model.uv0.size else True
    print(f"{args.model}: {model.triangle_count} triangles, textured={model.albedo is not None}, "
          f"missing_uv={missing_uv}")
    mesh = mesh_from_model(model, mat_type=args.mat, translation=(0.0, 0.0, args.translate_z))
    cfg = IntegratorConfig(bounces=args.bounces, metal_roughness_lobe=model.albedo is not None)
    r = ProgressiveRenderer(gltf_scene(mesh), cfg, args.size, args.size, device=args.device)
    return run_and_save(r, gltf_camera(), args, f"debug_gltf_{args.model}")


if __name__ == "__main__":
    main()
