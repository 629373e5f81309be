"""The port's spans (``bpt_tpu_torch.utils.profiling.span``) and the
benchmark's reader of them (``benchmark.program_spans``) on the CPU.

A device trace holds every ``bpt.*`` span the CPU path reaches, nested as
the layers nest, one ``bpt.renderer.frame``, ``bpt.staged.pool`` and
``bpt.optim.step`` a call; with the spans off no profiler range is opened.
Synthetic Chrome-trace events check the attribution of idle time, sync
calls and device operations (one launched on a second thread), and that
the benchmark's existing readings do not change with the program's spans
present.  Each of the nine readers reads None without a trace and its value
on the synthetic trace; a traced harness run at 32x32 reports the train
and interactive cells' readers (the render cell's staged pool runs on a
card alone).  The ``bpt.kernels.*`` spans wrap CUDA launches: the
``cuda``-marked case checks them on the card.
"""

import json
import math
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import record_function

from benchmark import harness, tracing
from benchmark.program_spans import ProgramTrace, _Nest, capture
from bpt_tpu_torch.core.rng import blue_noise_table
from bpt_tpu_torch.diff.inverse import optimize, render_avg
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.kernels.integration import staged_batch_step
from bpt_tpu_torch.renderer import ProgressiveRenderer
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu_torch.utils import profiling

torch.set_num_threads(2)

BN = blue_noise_table()
RES = 16
# the spans the CPU path reaches, each with the span it lies in on its thread (None: none)
PARENTS = {
    "bpt.renderer.frame": None, "bpt.renderer.camera": "bpt.renderer.frame", "bpt.renderer.display": None,
    "bpt.staged.batch": None, "bpt.staged.pool": "bpt.staged.batch", "bpt.staged.sort": "bpt.staged.pool",
    "bpt.optim.step": None, "bpt.optim.forward": "bpt.optim.step", "bpt.optim.backward": "bpt.optim.step",
    "bpt.optim.update": "bpt.optim.step", "bpt.replay.forward": "bpt.optim.forward",
    "bpt.replay.compose": "bpt.optim.forward", "bpt.replay.backward": "bpt.optim.backward",
}


def _emission_problem(cfg):
    base, camera = cornell_scene(device="cpu"), cornell_camera(device="cpu")

    def build(params):
        color = torch.cat([base.quads.color[:5], (params["emission"] * torch.ones(3))[None]])
        return base._replace(quads=base.quads._replace(color=color)), camera

    target = render_avg(build({"emission": torch.tensor(10.0)})[0], camera, cfg, RES, (1.0, 2.0),
                        torch.tensor([0.3, 0.7]), BN)
    return build, target


def _drive(build, target, cfg) -> dict:
    """A CPU renderer at 16²: ``render_sample`` and ``display``, then
    ``render(spp=3, batch=2)`` through ``staged_batch_step`` installed by
    hand (a frame, one pool of 2 frames, a display); a 2-step ``optimize``.
    The spans each makes."""
    r = ProgressiveRenderer(cornell_scene(), cfg, RES, RES, blue_noise=BN, device="cpu")
    r.batch_step = staged_batch_step(r)
    cam = cornell_camera()
    r.render_sample(cam)
    r.display()
    r.render(cam, spp=3, batch=2)
    optimize(build, {"emission": 4.0}, target, cfg, RES, steps=2, lr=0.5, device="cpu")
    return {"bpt.renderer.frame": 2, "bpt.renderer.camera": 2, "bpt.renderer.display": 2,
            "bpt.renderer.finish": 2 + 2, "bpt.staged.batch": 1, "bpt.staged.pool": 1, "bpt.staged.sort": 1,
            "bpt.optim.step": 2, "bpt.optim.forward": 2, "bpt.optim.backward": 2, "bpt.optim.update": 2,
            "bpt.replay.forward": 4, "bpt.replay.compose": 4, "bpt.replay.backward": 4}


def _parents(trace: ProgramTrace) -> dict:
    """{span name: {names of the spans each lies in directly, on its thread}}."""
    out: dict = {}
    for nest in trace._nests.values():
        for i, s in enumerate(nest.spans):
            p = nest.parent[i]
            out.setdefault(s[0], set()).add(None if p is None else nest.spans[p][0])
    return out


def test_device_trace_holds_the_program_spans_nested(tmp_path):
    cfg = IntegratorConfig(bounces=2)
    build, target = _emission_problem(cfg)
    with profiling.device_trace(str(tmp_path)):
        with record_function("window"):
            want = _drive(build, target, cfg)
    assert profiling._ON is False
    [path] = tmp_path.glob("*.pt.trace.json")
    trace = ProgramTrace(json.loads(path.read_text())["traceEvents"])
    assert {s[0] for s in trace.program_spans} == set(want)
    assert {name: trace.count(name) for name in want} == want
    parents = _parents(trace)
    for name, parent in PARENTS.items():
        assert parents[name] == {parent}, (name, parents[name])
    assert parents["bpt.renderer.finish"] == {"bpt.renderer.frame", "bpt.staged.batch"}


def test_capture_turns_spans_on_and_busy_capture_does_not():
    cfg = IntegratorConfig(bounces=2)
    r = ProgressiveRenderer(cornell_scene(), cfg, RES, RES, blue_noise=BN, device="cpu")
    seen = []

    def window():
        seen.append(profiling._ON)
        r.render_sample(cornell_camera())
        return len(seen)

    trace, out = capture(window)
    assert out == 1 and seen == [True] and trace.count("bpt.renderer.frame") == 1
    _, out = tracing.busy_capture(window, torch.device("cpu"))
    assert out == 2 and seen == [True, False] and profiling._ON is False


def test_spans_off_never_enter_record_function(monkeypatch):
    cfg = IntegratorConfig(bounces=2)
    build, target = _emission_problem(cfg)

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} was opened with the spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling._ON is False
    _drive(build, target, cfg)


# ---------------------------------------------------------------------------
# synthetic events: the main thread 1, autograd's thread 2; times in us
# ---------------------------------------------------------------------------

def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def _events() -> list:
    ann = [("window", 0, 1000, 1), ("job", 10, 890, 1), ("request", 700, 105, 1), ("request", 806, 89, 1),
           ("bpt.optim.step", 100, 400, 1), ("bpt.optim.forward", 110, 190, 1), ("bpt.kernels.k1", 120, 20, 1),
           ("bpt.optim.backward", 300, 150, 1), ("bpt.replay.backward", 310, 130, 2),
           ("bpt.optim.update", 450, 50, 1), ("bpt.optim.step", 520, 60, 1),
           ("bpt.renderer.frame", 720, 40, 1), ("bpt.renderer.camera", 720, 5, 1),
           ("bpt.renderer.display", 760, 40, 1),
           ("bpt.staged.batch", 810, 80, 1), ("bpt.staged.pool", 810, 50, 1), ("bpt.kernels.k2", 815, 5, 1),
           ("bpt.staged.sort", 830, 5, 1), ("bpt.renderer.finish", 860, 30, 1)]
    runtime = [("cudaLaunchKernel", 125, 1, 1), ("cudaMemcpyAsync", 200, 1, 5), ("cudaStreamSynchronize", 210, 1, 6),
               ("cudaLaunchKernel", 320, 2, 2), ("cudaEventSynchronize", 330, 2, 10), ("cudaLaunchKernel", 460, 1, 3),
               ("cudaLaunchKernel", 600, 1, 4), ("cudaMemcpy", 722, 1, 11), ("cudaLaunchKernel", 765, 1, 7),
               ("cudaLaunchKernel", 816, 1, 8), ("cudaStreamSynchronize", 832, 1, 12), ("cudaLaunchKernel", 870, 1, 9),
               ("cudaDeviceSynchronize", 905, 1, 13)]
    device = [("kernel", "void trace_kernel<false, 0, 0>(TraceArgs)", 130, 50, 1),
              ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 205, 5, 5),
              ("kernel", "void at::native::reduce_kernel<512, 1>", 330, 20, 2),
              ("kernel", "void at::native::elementwise_kernel<128, 2>", 470, 10, 3),
              ("kernel", "void at::native::elementwise_kernel<128, 2>", 610, 120, 4),
              ("kernel", "void at::native::elementwise_kernel<128, 4>", 770, 20, 7),
              ("kernel", "void phase_kernel<false, 0, 0>(StagedArgs)", 818, 32, 8),
              ("kernel", "void at::native::elementwise_kernel<128, 2>", 875, 5, 9)]
    return ([_x("user_annotation", n, ts, dur, tid) for n, ts, dur, tid in ann]
            + [_x("cuda_runtime", n, ts, 1, tid, correlation=c) for n, ts, tid, c in runtime]
            + [_x(cat, n, ts, dur, 7, correlation=c) for cat, n, ts, dur, c in device])


# per span name: device idle ms begun inside, sync calls, device operations launched inside
ATTRIBUTED = {
    "bpt.optim.step": (0.025 + 0.120 + 0.120 + 0.130, 2, 4), "bpt.optim.forward": (0.145, 1, 2),
    "bpt.kernels.k1": (0.0, 0, 1), "bpt.optim.backward": (0.120, 1, 1), "bpt.replay.backward": (0.0, 1, 1),
    "bpt.optim.update": (0.130, 0, 1), "bpt.renderer.frame": (0.040, 1, 0), "bpt.renderer.camera": (0.0, 1, 0),
    "bpt.renderer.display": (0.028, 0, 1), "bpt.staged.batch": (0.025 + 0.120, 1, 2),
    "bpt.staged.pool": (0.025, 1, 1), "bpt.kernels.k2": (0.0, 0, 1), "bpt.staged.sort": (0.0, 1, 0),
    "bpt.renderer.finish": (0.120, 0, 1),
}


def test_attribution_on_synthetic_events():
    trace = ProgramTrace(_events())
    got = trace.attributed()
    assert set(got) == set(ATTRIBUTED)
    for name, (idle_ms, syncs, ops) in ATTRIBUTED.items():
        assert got[name]["idle_ms"] == pytest.approx(idle_ms), name
        assert (got[name]["syncs"], got[name]["ops"]) == (syncs, ops), name
    assert [s[0] for s in trace.syncs] == ["cudaStreamSynchronize", "cudaEventSynchronize", "cudaMemcpy",
                                          "cudaStreamSynchronize", "cudaDeviceSynchronize"]
    assert trace.count("bpt.optim.step") == 2 and trace.count("bpt.replay.backward") == 1
    assert trace.per_unit("ops", ("bpt.staged.batch",), "bpt.staged.none") is None
    lines = trace.table().splitlines()
    assert len(lines) == 1 + len(ATTRIBUTED)
    step = next(line.split() for line in lines if line.startswith("bpt.optim.step "))
    assert step == ["bpt.optim.step", "2", "0.460", "0.070", "0.395", "2", "4"]


def test_existing_readings_unchanged_by_program_spans():
    events = _events()
    bare = [e for e in events if not e["name"].startswith("bpt.")
            and not (e["cat"] == "cuda_runtime" and "Synchronize" in e["name"] or e["name"] == "cudaMemcpy")]
    assert len(bare) == len(events) - 15 - 5  # 15 program spans, 5 sync calls
    units = [{"view": 0}, {"view": 1}]
    readings = []
    for trace in (tracing.Trace(bare), tracing.Trace(events), ProgramTrace(events)):
        readings.append((trace.spans, trace.idle_gaps(), trace.busy_s, trace.top_ops(), trace.device("k1"),
                         trace.device("k2"), trace.request_spans(units, 1), trace.window_s))
    assert readings[0] == readings[1] == readings[2]
    assert readings[0][1][0][0] == "job"


NINE = {  # metric: its value on the synthetic events
    "optim.idle_ms_per_step": 0.395 / 2, "optim.host_syncs_per_step": 2 / 2, "optim.device_ops_per_step": 4 / 2,
    "renderer.idle_ms_per_frame": 0.040 + 0.028, "renderer.host_syncs_per_frame": 1.0,
    "renderer.device_ops_per_frame": 1.0, "staged.idle_ms_per_pool": 0.145, "staged.host_syncs_per_pool": 1.0,
    "staged.device_ops_per_pool": 2.0,
}


@pytest.mark.parametrize("name", sorted(NINE))
def test_reader_none_untraced_and_its_value_on_a_trace(name):
    read = harness.metric_reader(name).read
    assert read(SimpleNamespace(trace=None)) is None
    trace = ProgramTrace(_events())
    assert read(SimpleNamespace(trace=trace, program_trace=trace)) == pytest.approx(NINE[name])


TEXTURED = json.loads((harness.HERE / "configs" / "gltf_textured.json").read_text())["scene"]
SMALL = {  # the cells at 32x32 and a few units, as the benchmark's own CPU tests cut them
    "cornell.train": {"config": {"size": 32, "train": {"param": "emission", "true": 10.0, "init": 4.0, "lr": 0.5,
                                                       "steps": 4, "frames": 2, "clip": None}}},
    "textured.interactive": {"config": {"size": 32, "scene": {**TEXTURED, "heightfield_side": 16, "map_size": 64}},
                             "traffic": {"checks": 2, "patches": 3, "warmup": 1, "trace_seconds": 0.3}},
}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_run_reads_the_new_metrics(workload, monkeypatch, capsys):
    """A ``--trace 1`` run of the cell on the CPU (the harness's capture
    waits for a card; its wait is taken out here) reports its three new
    metrics from the window with the port's spans on (the render cell
    installs its staged batch step on a card alone)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    result = harness.run(workload, 2 ** 31 + 977, 0.3, True, "cpu", overrides=SMALL[workload])
    assert result["correct"]
    mine = {m["name"] for m in harness.load_spec()["per_layer"] if m["name"] in NINE and workload in m["workloads"]}
    assert len(mine) == 3
    assert mine <= set(result["metrics"])
    assert all(math.isfinite(result["metrics"][m]["value"]) and result["metrics"][m]["value"] >= 0 for m in mine)
    err = capsys.readouterr().err
    assert "the port's spans on:" in err and "bpt." in err


def test_nest_takes_the_innermost_span_and_its_ancestors():
    nest = _Nest([("a", 0.0, 10.0, 1), ("b", 1.0, 4.0, 1), ("c", 2.0, 3.0, 1), ("d", 5.0, 9.0, 1)])
    assert nest.names_at(2.5) == {"a", "b", "c"}
    assert nest.names_at(4.5) == {"a"}
    assert nest.names_at(6.0) == {"a", "d"}
    assert nest.names_at(11.0) == set() and nest.names_at(-1.0) == set()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bpt.kernels.* spans wrap CUDA launches")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_spans_hold_their_launches(cuda_device, tmp_path):
    """On the card: a Cornell renderer with the staged batch step renders 3
    samples under ``device_trace``; every K1, K2 and key-kernel launch lies
    in its ``bpt.kernels.*`` span, inside ``bpt.renderer.frame`` and
    ``bpt.staged.pool``."""
    from bpt_tpu_torch.kernels.integration import attach_cuda_path

    r = ProgressiveRenderer(cornell_scene(), IntegratorConfig(bounces=4), 64, 64, blue_noise=BN, device=cuda_device)
    attach_cuda_path(r, reorder=True)
    r.render(cornell_camera(), spp=3, batch=2)
    torch.cuda.synchronize()
    with profiling.device_trace(str(tmp_path)):
        with record_function("window"):
            r.render(cornell_camera(), spp=3, batch=2)
            torch.cuda.synchronize()
    [path] = tmp_path.glob("*.pt.trace.json")
    trace = ProgramTrace(json.loads(path.read_text())["traceEvents"])
    got = trace.attributed()
    assert trace.device("k1")[1] == 1 and trace.device("k2")[1] == 4 and trace.device("key")[1] == 3
    k1 = [op for op in trace.ops if tracing.kind_of(op.name) == "k1"]
    assert got["bpt.kernels.k1"]["ops"] >= 1 and got["bpt.renderer.frame"]["ops"] >= got["bpt.kernels.k1"]["ops"]
    assert trace._names(trace.launch[k1[0].corr][1]) >= {"bpt.kernels.k1", "bpt.renderer.frame"}
    for kind, name in (("k2", "bpt.kernels.k2"), ("key", "bpt.kernels.key")):
        for op in (op for op in trace.ops if tracing.kind_of(op.name) == kind):
            assert trace._names(trace.launch[op.corr][1]) >= {name, "bpt.staged.pool", "bpt.staged.batch"}
    assert trace.count("bpt.staged.sort") == 3
