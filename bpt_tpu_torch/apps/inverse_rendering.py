"""Demo 6 — inverse rendering: recover a textured glTF model's albedo map.

    python -m bpt_tpu_torch.apps.inverse_rendering --model helmet --models-dir DIR [--pallas] [--device cpu]

The port of the JAX demo (``apps/inverse_rendering.py``), with its flags:
it renders a target of the textured model (the DamagedHelmet by default),
with its true albedo downsampled to ``--tex-size``, resets the albedo to
grey and recovers it by Adam through the whole path tracer.  ``--pallas``
takes the fused route, the CUDA megakernel's grads mode with its
path-replay VJP and the deferred composition that carries the texel
gradients (``trace_image_fused(differentiable=True)``); without it, the
wavefront route, autograd through ``trace_image``, whose mesh walk is the
CUDA closest-hit kernel with its recompute VJP.  ``--reorder`` takes the
fused route on the staged path: the frames of each render as one sorted
pool of the staged kernel, with the same VJP.  The glTF assets are not in the
repository: a missing file fails with its path.  ``recover_albedo`` takes
any textured model (the chip smoke run drives it on a synthetic stand-in).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bpt_tpu_torch.apps.common import base_parser


def recover_albedo(model, bounces: int, size: int, steps: int, lr: float, tex_size: int = 64, fused: bool = True,
                   reorder: bool = False, camera=None, device=None, frames=(1.0, 2.0)) -> dict:
    """Recover ``model``'s albedo (downsampled to ``tex_size``², clipped to
    [0, 1]) from a ``size``² target from ``camera`` (the glTF demo's by
    default), starting from grey 0.5: ``{"losses", "err0", "err1",
    "albedo", "true_albedo"}``, the albedo errors being mean absolute
    errors against the true map.  The mesh and its kernel tables go to the
    device once; every step reuses them."""
    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.device import default_device
    from bpt_tpu_torch.diff.inverse import optimize, render_avg
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model

    if model.albedo is None:
        raise ValueError("the model must be textured (an albedo map) for albedo recovery")
    device = default_device(device)
    ah, aw = model.albedo.shape[:2]
    t = tex_size
    true_albedo = torch.as_tensor(np.ascontiguousarray(model.albedo[:: max(ah // t, 1), :: max(aw // t, 1)][:t, :t]),
                                  dtype=torch.float32).to(device)
    base = gltf_scene(mesh_from_model(model, mat_type=1), device=device)
    camera = (gltf_camera() if camera is None else camera).to(device)
    cfg = IntegratorConfig(bounces=bounces, metal_roughness_lobe=True)

    def build(params):
        return base._replace(mesh=base.mesh._replace(albedo=params["albedo"])), camera

    rv = np.array([0.3, 0.7], np.float32)
    bn = torch.as_tensor(blue_noise_table()).to(device)
    with torch.no_grad():
        target = render_avg(build({"albedo": true_albedo})[0], camera, cfg, size, frames, rv, bn, fused=fused,
                            reorder=reorder)
    init = {"albedo": torch.full_like(true_albedo, 0.5)}
    result = optimize(build, init, target, cfg, size, steps=steps, lr=lr, frames=frames,
                      param_clip=lambda p: {"albedo": torch.clamp(p["albedo"], 0.0, 1.0)}, fused=fused,
                      reorder=reorder, device=device)
    albedo = result.params["albedo"]
    return {"losses": result.losses.cpu().numpy(), "err0": float((init["albedo"] - true_albedo).abs().mean()),
            "err1": float((albedo - true_albedo).abs().mean()), "albedo": albedo, "true_albedo": true_albedo}


def main(argv=None):
    from bpt_tpu_torch.apps.gltf_model import PRESETS
    from bpt_tpu_torch.io import load_gltf

    p = base_parser("Inverse rendering: recover a PBR albedo map")
    p.add_argument("--model", choices=sorted(PRESETS), default="helmet")
    p.add_argument("--models-dir", default="models", help="directory of the glTF assets")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--tex-size", type=int, default=64, help="optimized map resolution")
    p.add_argument("--pallas", action="store_true",
                   help="the fused route: the megakernel's grads mode, its path-replay VJP and the deferred "
                        "composition's texel gradients")
    p.add_argument("--reorder", action="store_true",
                   help="the fused route on the staged path: each render's frames as one sorted pool (implies "
                        "--pallas)")
    args = p.parse_args(argv)

    name, scale, flip = PRESETS[args.model]
    model = load_gltf(os.path.join(args.models_dir, name), initial_scale=scale, flip_z=flip)
    out = recover_albedo(model, args.bounces, args.size, args.steps, args.lr, args.tex_size,
                         fused=args.pallas or args.reorder, reorder=args.reorder, device=args.device)
    losses = out["losses"]
    print(f"loss: {losses[0]:.6f} -> {losses[-1]:.6f} over {args.steps} steps")
    print(f"albedo mean abs error: {out['err0']:.4f} -> {out['err1']:.4f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the optimization did not reduce the loss")
    return out


if __name__ == "__main__":
    main()
