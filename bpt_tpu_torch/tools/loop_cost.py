"""Calibrate the serial cost of walk-loop constructs on the card (port of
``tools/loop_cost.py``).

The BVH walk is a loop whose body chains: a row load -> vector math -> a
cross-lane any-reduce -> a branch.  If the chain's latency (not the card's
throughput) dominates, cutting vector operations per row buys nothing: this
microbenchmark measures the cost per iteration against (vector operations,
any-reduce, branch) to find the floor.  Each configuration runs the kernel
of ``csrc/loop_cost.cu`` (``kernels/loop_cost.py``) once to warm up, then 5
times on inputs that differ by 1e-6, timed with CUDA events around the 5
launches, and prints the JAX tool's line.

Usage: python -m bpt_tpu_torch.tools.loop_cost [--iters 4000] [--device cpu]

It runs on the card; ``--device cpu`` runs the plain PyTorch version (slow:
give it few ``--iters``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from bpt_tpu_torch.device import default_device
from bpt_tpu_torch.kernels.loop_cost import CONFIGS, TILE, loop_cost

TIMED_CALLS = 5


def table() -> np.ndarray:
    """The tool's table: arange(64 * 128) * 1e-6 + 1 in float32."""
    return np.arange(64 * 128, dtype=np.float32).reshape(64, 128) * np.float32(1e-6) + np.float32(1.0)


def tile_input(i: int) -> np.ndarray:
    """The input of timed call ``i``: ones + i * 1e-6 in float32."""
    return np.ones(TILE, np.float32) + np.float32(i) * np.float32(1e-6)


def run(n_iter: int, n_ops: int, use_reduce: bool, use_cond: bool, device="cuda") -> dict:
    """Time one configuration on ``device``: prints the JAX tool's line and
    returns its numbers (``ns_per_iter``, ``ms`` per call) and the last
    output."""
    device = torch.device(device)
    tab = torch.from_numpy(table()).to(device)
    xs = [torch.from_numpy(tile_input(i)).to(device) for i in range(TIMED_CALLS)]
    out = loop_cost(tab, xs[0], n_iter, n_ops, use_reduce, use_cond)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for x in xs:
            out = loop_cost(tab, x, n_iter, n_ops, use_reduce, use_cond)
        end.record()
        torch.cuda.synchronize(device)
        dt = start.elapsed_time(end) / 1e3 / TIMED_CALLS
    else:
        t0 = time.perf_counter()
        for x in xs:
            out = loop_cost(tab, x, n_iter, n_ops, use_reduce, use_cond)
        dt = (time.perf_counter() - t0) / TIMED_CALLS
    ns = dt / n_iter * 1e9 if n_iter else float("nan")
    print(f"tile={TILE} ops={n_ops:4d} reduce={int(use_reduce)} "
          f"cond={int(use_cond)}: {ns:8.1f} ns/iter  ({dt * 1e3:.2f} ms total)", flush=True)
    return {"config": (n_ops, use_reduce, use_cond), "ns_per_iter": ns, "ms": dt * 1e3, "out": out}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--device", default=None, help="cpu runs the plain version; default: the card")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu, the plain PyTorch version"
    print(f"device: {name}", flush=True)
    return [run(args.iters, *config, device) for config in CONFIGS]


if __name__ == "__main__":
    main()
