"""Time the staged pool per sort-key mode on the card: the counterpart of
the JAX package's ``tools/key_sweep.py``, which simulated the TPU packets'
leaf rows per key; here the phases are timed instead.

    python -m bpt_tpu_torch.tools.key_sweep [--size 1024] [--frames 8] [--pools capacity,rugged,cornell]

Each pool is ``--frames`` frames (2, 3, ...) of ``--size``² pixels, 4
bounces, one phase per bounce: bench.py's capacity mesh (the
524,288-triangle heightfield from the glTF camera), its rugged variant, and
the Cornell box.  For each mode of ``staged.KEY_MODES``: the whole pool
(CUDA events, 5 pools), K2's phases and the key kernel's two passes
(device time by torch.profiler, 2 pools), and the keys and torch.sort of
its three boundaries (CUDA events around each, 3 pools).  Then, as the limit of the coarsest key, the phases
of the same pool with its lanes left unsorted (each phase reads the state
in the order the last one wrote it; device time), and 8 K1 launches
(CUDA events).  Prints the card's name and power limit, then one JSON line
per pool.  It needs a card: without one it exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

POOLS = ("capacity", "rugged", "cornell")


def _device_ms(fn, name: str, per_call: int, iters: int = 2) -> float:
    """Device ms per call of ``fn``, which launches ``per_call`` kernels
    whose name contains ``name``: their mean per launch by torch.profiler
    (a profile may miss some launches), times ``per_call``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(getattr(ev, "self_device_time_total", 0.0), ev.count) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and name in ev.key]
    return sum(us for us, _ in rows) / 1e3 / max(sum(n for _, n in rows), 1) * per_call


def _scene(name: str, device):
    from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, heightfield_model, mesh_from_model
    from bpt_tpu_torch.scenes.types import DIFFUSE

    if name == "cornell":
        return cornell_scene(device=device), cornell_camera(device=device)
    model = heightfield_model(rugged=name == "rugged")
    return (gltf_scene(mesh_from_model(model, mat_type=DIFFUSE, use_native="require"), device=device),
            gltf_camera(device=device))


def sweep(name: str, size: int, frames: int) -> dict:
    """The numbers of one pool (see the module docstring)."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import megakernel, staged
    from bpt_tpu_torch.utils.profiling import event_ms

    dev = torch.device("cuda")
    bn = torch.as_tensor(blue_noise_table()).to(dev)
    scene, cam = _scene(name, dev)
    cfg = IntegratorConfig(bounces=4)
    fcs = [2.0 + i for i in range(frames)]
    rvs = [np.array([(i * 0.173) % 1.0, (i * 0.519) % 1.0], np.float32) for i in range(frames)]
    out = {"pool": name, "lanes": frames * size * size, "modes": {}}
    for mode in staged.KEY_MODES:
        def pool(record=None, mode=mode):
            return staged.trace_staged(scene, cam, cfg, size, size, fcs, rvs, bn, key_mode=mode, record=record)

        row = {"pool_ms": event_ms(pool, 5), "phases_device_ms": _device_ms(pool, "phase_kernel", cfg.bounces),
               "keys_device_ms": sum(_device_ms(pool, kernel, cfg.bounces - 1)
                                     for kernel in ("key_box_kernel", "key_kernel")),
               "keys_ms": 0.0, "sorts_ms": 0.0}
        for _ in range(3):
            rec = []
            pool(rec)
            torch.cuda.synchronize()
            for (_, a), (label, b) in zip(rec, rec[1:]):
                kind = label.split()[0] + "s_ms"
                if kind in row:
                    row[kind] += a.elapsed_time(b) / 3
        out["modes"][mode] = row

    pool_def = staged.make_pool(size, size, fcs, rvs, dev)
    identity = torch.arange(pool_def.lanes, device=dev)

    def unsorted():
        outputs = megakernel.empty_outputs(scene, cfg, (frames, size, size), False, dev)
        state = None
        for lo in range(cfg.bounces):
            state = staged.launch_phase(scene, cam, cfg, pool_def, bn, state, None if lo == 0 else identity, lo,
                                        lo + 1, outputs)

    def k1_frames():
        return [megakernel.trace_image_fused(scene, cam, cfg, size, size, f, rv, bn) for f, rv in zip(fcs, rvs)]

    out["unsorted_phases_device_ms"] = _device_ms(unsorted, "phase_kernel", cfg.bounces)
    out["k1_frames_ms"] = event_ms(k1_frames, 5)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--pools", default=",".join(POOLS), help=f"comma-separated, of {', '.join(POOLS)}")
    args = parser.parse_args(argv)
    pools = [p for p in args.pools.split(",") if p]
    if any(p not in POOLS for p in pools):
        parser.error(f"--pools takes {', '.join(POOLS)}")
    import torch

    if not torch.cuda.is_available():
        print("key_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for name in pools:
        print(json.dumps(sweep(name, args.size, args.frames)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
