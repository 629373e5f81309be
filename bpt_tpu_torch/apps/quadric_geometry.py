"""Demo 2 — the twelve transformed quadric shapes.

    python -m bpt_tpu_torch.apps.quadric_geometry --shape-k 0.5 --mat 4 [--device cpu]
"""

from bpt_tpu_torch.apps.common import base_parser, run_and_save


def main(argv=None):
    p = base_parser("Transformed quadric geometry path tracer")
    p.add_argument("--shape-k", type=float, default=0.5)
    p.add_argument("--mat", type=int, default=4, help="material for all shapes")
    args = p.parse_args(argv)

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.quadric_geometry import quadric_camera, quadric_geometry_scene

    scene = quadric_geometry_scene(shape_k=args.shape_k, all_shapes_mat=args.mat)
    cfg = IntegratorConfig(bounces=args.bounces, transparent_tint=True)
    r = ProgressiveRenderer(scene, cfg, args.size, args.size, device=args.device)
    return run_and_save(r, quadric_camera(), args, "quadric_geometry")


if __name__ == "__main__":
    main()
