"""The benchmark's harness: one run of one cell, driven by ``BENCHMARK.json``
and the files it names.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json`` (the ``file`` of the configuration:
  its sizes) and ``benchmark/configs/<config>.py`` (its inputs, made from
  the seed, and the scene each side is built from);
- ``benchmark/traffic/<traffic>.json``: the mix, read by the one generator
  (``benchmark.generator``);
- ``benchmark/metrics/<metric>.py``: ``read(ctx)``, the metric's value or
  None where it finds nothing to read;
- ``benchmark/limits/<workload>.json``: each compared number's limit.

A run: the inputs from the seed, set-up (the program's scene, warm-up of
every shape the traffic uses; ``setup_s`` from process start to its end,
its stages' ends on standard error),
the window (``--seconds`` of the traffic's units, each ending in a sync, the
window extended to the last one's end; in a cell with an end-to-end metric
from the device trace, the whole window under ``benchmark.tracing``'s
``busy_capture``), the device's peak memory, the
program's state freed, then the reference's comparison.  With ``--trace
1`` the window runs under ``torch.profiler`` (at most the mix's
``trace_seconds``), the profiler's launch counts of the port's kernels are
held to the port's own counters, and the per-layer metrics are reported;
the roofline bounds are counted before it, on the plain reference, for the
view of the window's first request.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark.generator import KINDS, Spans, sync

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bpt_tpu")
TRACE_TRIES = 3
# The share of the port's launches that a whole window's capture may lose before the run fails: CUPTI drops
# a record now and then over some 10^5 (2 of 14,160 K1 launches in one 20 s window on the card), and the
# busy time then reads short by about that share; the window cannot be run again.
BUSY_LOST_SHARE = 1e-3


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in ``path``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, here: Path = HERE):
    return load_module(here / "metrics" / f"{name}.py", f"benchmark_metric_{name.replace('.', '_')}")


def applies(metric: dict, workload: str, reported: set | None = None) -> bool:
    """Whether a metric belongs to a cell: listed in its ``workloads``, or,
    without that key, every cell (an end-to-end metric) or every cell that
    reports what it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


class Cell:
    """One cell of ``BENCHMARK.json``: its configuration (sizes and module),
    its traffic mix and its limits.  ``overrides`` replace entries of the
    configuration's and the mix's files (the CPU tests' small sizes)."""

    def __init__(self, spec: dict, workload: str, seed: int, device, trace: bool = False,
                 overrides: dict | None = None, here: Path = HERE, root: Path = ROOT, t_start: float | None = None):
        entries = {w["name"]: w for w in spec["workloads"]}
        if workload not in entries:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = entries[workload]
        self.name = workload
        config = {c["name"]: c for c in spec["configs"]}[self.entry["config"]]
        overrides = overrides or {}
        self.spec = {**load_json(root / config["file"]), **overrides.get("config", {})}
        self.mix = {**load_json(here / "traffic" / f"{self.entry['traffic']}.json"), **overrides.get("traffic", {})}
        self.limits = load_json(here / "limits" / f"{workload}.json")
        self.config = load_module(here / "configs" / f"{config['name']}.py", f"benchmark_config_{config['name']}")
        self.seed, self.device, self.trace = int(seed), torch.device(device), trace
        self.spans = Spans()
        self.inputs = None
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.marks: list = []  # (stage, seconds since process start) of the set-up's stages

    def mark(self, stage: str) -> None:
        """Records that the set-up's ``stage`` ended now (the device's queue drained first)."""
        sync(self.device)
        self.marks.append((stage, time.perf_counter() - self.t_start))


def _window(kind, seconds: float) -> tuple[list, float]:
    """Units until ``seconds`` have passed; the window ends with the last."""
    units, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        units.append(kind.unit())
    return units, time.perf_counter() - t0


def launch_counts() -> dict:
    """The port's own launch counters, summed over configurations."""
    from bpt_tpu_torch.kernels import megakernel, staged

    return {"k1": sum(megakernel.LAUNCHES.values()), "k1_grad": sum(megakernel.GRAD_LAUNCHES.values()),
            "k2": sum(staged.STAGED_LAUNCHES.values()), "k2_grad": sum(staged.STAGED_GRAD_LAUNCHES.values()),
            "key": sum(staged.KEY_LAUNCHES.values())}


def traced_window(kind, seconds: float):
    """(Trace, units, counters' deltas) of a window under the profiler whose
    launch counts of K1, K2 and the key kernel equal the port's counters; a
    session that lost launches is run again, and after TRACE_TRIES raises."""
    from benchmark.tracing import capture

    seen = None
    for _ in range(TRACE_TRIES):
        before = launch_counts()
        kind.spans.records.clear()
        trace, (units, _) = capture(lambda: _window(kind, seconds))
        after = launch_counts()
        counters = {k: after[k] - before[k] for k in after}
        seen = {k: trace.device(k)[1] for k in counters}
        if seen == counters:
            return trace, units, counters
        print(f"profiler lost launches: counted {seen}, the port's counters {counters}; tracing again",
              file=sys.stderr)
    raise RuntimeError(f"the profiler's launch counts {seen} never matched the port's counters")


def busy_window(kind, seconds: float, device) -> tuple:
    """(Busy, units, seconds) of a whole window under ``busy_capture``.  On a
    card the profiler's launches of K1, K2 and the key kernel are held to the
    port's counters: a session that lost more than ``BUSY_LOST_SHARE`` of
    them, or counted more, fails rather than report its busy time."""
    from benchmark.tracing import busy_capture

    before = launch_counts() if device.type == "cuda" else {}
    busy, (units, window_s) = busy_capture(lambda: _window(kind, seconds), device)
    if device.type == "cuda":
        after = launch_counts()
        counters = {k: after[k] - before[k] for k in after}
        seen = {k: busy.launches.get(k, 0) for k in counters}
        lost, n = sum(counters.values()) - sum(seen.values()), sum(counters.values())
        if any(seen[k] > counters[k] for k in counters) or lost > BUSY_LOST_SHARE * n:
            raise RuntimeError(f"the profiler lost launches: counted {seen}, the port's counters {counters}")
        if lost:
            print(f"the profiler lost {lost} of the port's {n} launches: counted {seen}", file=sys.stderr)
    print(f"the device was busy {busy.seconds!r} s of the {window_s!r} s window; "
          f"{sum(u.get('steps', 0) for u in units) / window_s!r} steps/s under the capture", file=sys.stderr)
    return busy, units, window_s


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", spec: dict | None = None,
        overrides: dict | None = None, t_start: float | None = None, control: bool = False, here: Path = HERE,
        root: Path = ROOT) -> dict:
    """One run of one cell: the result line's object.  ``control`` puts the
    reference computed in bfloat16 in the program's place in the check (the
    control's readings; never in a benchmark run).  ``here`` and ``root`` are the directories
    the cell's files are looked up in (``benchmark/`` and the checkout)."""
    t_start = time.perf_counter() if t_start is None else t_start
    # The port falls back to its synthesised blue-noise table where the reference's asset is absent; point
    # it into the checkout, where no asset lies, so that it reads nothing outside it: the reference (and
    # every table the benchmark hands the port) is that synthesised table.
    os.environ["BPT_BLUE_NOISE_PATH"] = str(here / "no-blue-noise-asset.png")
    warnings.filterwarnings("ignore", message="blue-noise asset not loadable")
    spec = load_spec(root) if spec is None else spec
    cell = Cell(spec, workload, seed, device, trace, overrides, here, root, t_start)
    cell.marks.append(("imports", time.perf_counter() - t_start))
    cell.mark("the card's context")
    cell.spans.profiling = trace
    cell.inputs = cell.config.make_inputs(cell.spec, cell.seed, cell.device)
    cell.mark("inputs")
    kind = KINDS[cell.mix["kind"]](cell)
    cuda = cell.device.type == "cuda"
    work = {}
    if trace:  # the plain frame of the lane counts runs before the program's set-up: its memory is not the port's
        from benchmark.workcounts import bounds

        work = bounds(cell, kind.first_view())
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        cell.mark("the roofline's plain frame")
    kind.setup()
    cell.mark("warm-up")
    setup_s = time.perf_counter() - t_start
    print("set-up, seconds since process start at the end of each stage: "
          + ", ".join(f"{stage} {s:.3f}" for stage, s in cell.marks), file=sys.stderr)
    tr, counters, busy = None, {}, None
    if trace:
        tr, units, counters = traced_window(kind, min(seconds, float(cell.mix["trace_seconds"])))
        window_s = tr.window_s
    elif any(m["source"] == "device_trace" and applies(m, workload) for m in spec["end_to_end"]):
        cell.spans.records.clear()
        busy, units, window_s = busy_window(kind, seconds, cell.device)
    else:
        cell.spans.records.clear()
        units, window_s = _window(kind, seconds)
    sync(cell.device)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = SimpleNamespace(cell=cell, kind=kind, setup_s=setup_s, window_s=window_s, units=units, trace=tr,
                          work=work, counters=counters, spans=cell.spans, busy=busy)
    metrics = {}
    wanted = spec["per_layer"] if trace else spec["end_to_end"]
    reported = {m["name"] for m in spec["end_to_end"] if applies(m, workload)}
    for m in wanted:
        if not applies(m, workload, None if not trace else reported):
            continue
        value = metric_reader(m["name"], here).read(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} read nothing in {workload}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    lat = [u["latency_s"] for u in units if "latency_s" in u]
    if lat:
        print(f"{len(lat)} requests, latency median {1e3 * statistics.median(lat)} ms", file=sys.stderr)
    kind.release()
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference computes in float32 throughout
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    numbers = kind.check(control=control)
    print(f"the reference's check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])} for k, v in numbers.items() if k in cell.limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and len(checks) == len(cell.limits)
    device_info = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
                   "kind": torch.cuda.get_device_name(0) if cell.device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    result = {"correct": bool(correct), "attempted": len(units), "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = checks
    return result


def forbidden_modules() -> list[str]:
    """The modules loaded in this process whose top-level name is one of
    FORBIDDEN, compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})
