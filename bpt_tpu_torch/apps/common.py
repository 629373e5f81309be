"""Shared CLI plumbing for the demo apps.

Each app builds its demo scene, renders N progressive samples, tonemaps and
writes a PNG (through PIL when it is importable, else a ``.npy`` of the
display image).  The flags are the JAX apps' (``apps/common.py``), except
that the kernel is the default on the card (no ``--pallas``) and
``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--size", type=int, default=256, help="image is size x size")
    p.add_argument("--spp", type=int, default=32, help="progressive samples")
    p.add_argument("--bounces", type=int, default=6)
    p.add_argument("--out", type=str, default=None, help="output PNG path (default <demo>.png here)")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the card (cuda), 'cpu' for the plain versions")
    return p


def save_image(img: np.ndarray, out: str) -> str:
    """Write the (H, W, 3) display image, row 0 at the bottom: a PNG through
    PIL, or ``<out>.npy`` where PIL is missing.  Returns the path written."""
    try:
        from PIL import Image
    except ImportError:
        np.save(out + ".npy", img)
        return out + ".npy"
    Image.fromarray((np.flipud(np.clip(img, 0.0, 1.0)) * 255).astype(np.uint8)).save(out)
    return out


def run_and_save(renderer, camera, args, default_name: str) -> np.ndarray:
    """Render twice (the first pass builds the kernel and warms up), report
    the rate of the second, save the image."""
    t0 = time.perf_counter()
    renderer.render(camera, spp=args.spp)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    renderer.render(camera, spp=args.spp)
    img = renderer.display(apply_denoise=not args.no_denoise, exposure=args.exposure)
    if img.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    img = img.cpu().numpy()
    rays = args.size * args.size * args.bounces * args.spp
    print(f"{default_name}: {args.size}x{args.size} {args.spp}spp {args.bounces}b on {renderer.device} "
          f"in {dt:.2f}s ({rays / dt / 1e6:.1f} Mrays/s; build + warm-up render {warm_s:.2f}s)")
    print(f"wrote {save_image(img, args.out or f'{default_name}.png')}")
    return img


def staged_batches(renderer) -> None:
    """``--reorder``: trace each batch of samples as one staged pool — on
    the card through ``attach_cuda_path(reorder=True)``, on the CPU through
    the same batch step's plain phases."""
    from bpt_tpu_torch.kernels.integration import attach_cuda_path, staged_batch_step

    if renderer.device.type == "cuda":
        attach_cuda_path(renderer, reorder=True)
    else:
        renderer.batch_step = staged_batch_step(renderer)
