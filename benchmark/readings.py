"""The readings that a cell's limits are set from, on the card, in one
process: for each seed, one run of the cell (a short window) and its
compared numbers, with the program as it is (``program``), with the
reference computed in bfloat16 in its place (``control``), or with a fault
of ``benchmark.faults`` planted in its timed path.

    python3 -m benchmark.readings --workload <name> --mode program --seeds 11,12,13 --seconds 3

Prints one JSON line per seed.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import resource
import sys
import time
import traceback


def rss_mb() -> float:
    """The process's peak resident memory, in MiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import faults, harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        fault = faults.FAULTS[args.mode]() if args.mode in faults.FAULTS else contextlib.nullcontext()
        try:
            with fault:
                r = harness.run(args.workload, seed, args.seconds, False, "cuda", control=args.mode == "control",
                                t_start=t0)
            line = {"workload": args.workload, "mode": args.mode, "seed": seed, "correct": r["correct"],
                    "checks": {k: v["value"] for k, v in r["checks"].items()}, "metrics": r["metrics"],
                    "wall_s": time.perf_counter() - t0, "host_rss_mb": rss_mb(),
                    "device_allocated_mb": torch.cuda.memory_allocated() / 2 ** 20}
        except Exception as exc:  # a control or a fault that crashes gives no number: report it and go on
            traceback.print_exc()
            line = {"workload": args.workload, "mode": args.mode, "seed": seed, "error": repr(exc)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
