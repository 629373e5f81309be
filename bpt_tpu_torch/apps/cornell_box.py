"""Demo 1 — the Cornell box with two spheres.

    python -m bpt_tpu_torch.apps.cornell_box --size 256 --spp 32 [--device cpu]
"""

from bpt_tpu_torch.apps.common import base_parser, run_and_save


def main(argv=None):
    p = base_parser("Cornell box path tracer")
    p.add_argument("--light-plane", type=int, default=6, choices=range(1, 7))
    p.add_argument("--light-radius", type=float, default=50.0)
    p.add_argument("--right-sphere-mat", type=int, default=3, help="1 diffuse, 2 transparent, 3 metal, 4 clearcoat")
    args = p.parse_args(argv)

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene

    scene = cornell_scene(quad_light_plane=args.light_plane, quad_light_radius=args.light_radius,
                          right_sphere_mat=args.right_sphere_mat)
    r = ProgressiveRenderer(scene, IntegratorConfig(bounces=args.bounces), args.size, args.size, device=args.device)
    return run_and_save(r, cornell_camera(), args, "cornell_box")


if __name__ == "__main__":
    main()
