"""Demo 3 — the Preetham physical sky over a sun-lit open Cornell box.

    python -m bpt_tpu_torch.apps.physical_sky --sun-rx 298 --sun-ry 318 [--device cpu]
"""

from bpt_tpu_torch.apps.common import base_parser, run_and_save


def main(argv=None):
    p = base_parser("Physical sky path tracer")
    p.add_argument("--sun-rx", type=float, default=298.0, help="sun rotation X, degrees")
    p.add_argument("--sun-ry", type=float, default=318.0, help="sun rotation Y, degrees")
    args = p.parse_args(argv)

    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.renderer import ProgressiveRenderer
    from bpt_tpu_torch.scenes.sky_scene import physical_sky_scene, sky_camera

    scene = physical_sky_scene(args.sun_rx, args.sun_ry)
    cfg = IntegratorConfig(bounces=args.bounces, env="sky", nee="sun")
    r = ProgressiveRenderer(scene, cfg, args.size, args.size, device=args.device)
    return run_and_save(r, sky_camera(), args, "physical_sky")


if __name__ == "__main__":
    main()
