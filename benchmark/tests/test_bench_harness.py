"""The harness on the CPU at 32x32 (the port's plain versions): every
traffic loop runs and is judged correct, the bfloat16 control and each
fault the timed path can have are judged not correct, a run that finds no
card prints no result, a new configuration, traffic mix or metric is found
by its name alone, and BENCHMARK.json keeps to the contract's names and
units.  The card's case runs each cell briefly through the command."""

import copy
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import faults, harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SEED = 2 ** 31 + 977  # larger than 32 signed bits hold
CELLS = ("cornell.train", "textured.render", "textured.train", "textured.interactive")


def small(workload: str) -> dict:
    """Overrides that cut a cell to 32x32 and a few units on the CPU."""
    config = "cornell" if workload.startswith("cornell") else "gltf_textured"
    spec = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    out = {"config": {"size": 32}, "traffic": {}}
    if config == "gltf_textured":
        out["config"]["scene"] = {**spec["scene"], "heightfield_side": 16, "map_size": 64}
    if workload.endswith("train"):
        out["config"]["train"] = {**spec["train"], "steps": 4, "frames": 2, "tex_size": 8}
    elif workload.endswith("render"):
        out["traffic"] = {"spp": 5, "batch": 2, "checks": 2, "patches": 3, "warmup": 1}
    else:
        out["traffic"] = {"checks": 2, "patches": 3, "warmup": 1}
    return out


def run_small(workload: str, control: bool = False, **kw) -> dict:
    return harness.run(workload, SEED, 0.3, False, "cpu", overrides=small(workload), control=control, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_traffic_loop_runs_and_is_correct(workload):
    result = run_small(workload)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    spec = harness.load_spec()
    wanted = {m["name"] for m in spec["end_to_end"] if harness.applies(m, workload)}
    assert set(result["metrics"]) == wanted
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_is_not_correct(workload):
    result = run_small(workload, control=True)
    assert not result["correct"], result["checks"]


FAULTS = [("cornell.train", "adam_leaves_state"), ("cornell.train", "half_the_frames"),
          ("textured.train", "adam_leaves_state"), ("textured.train", "half_the_frames"),
          ("textured.render", "half_the_samples"), ("textured.render", "display_altered"),
          ("textured.interactive", "display_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f}" for w, f in FAULTS])
def test_broken_timed_path_is_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        result = run_small(workload)
    assert not result["correct"], result["checks"]


def test_no_card_prints_no_result(capsys, monkeypatch):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "cornell.train", "--seed", str(SEED), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a limits file and a metric added as
    files, and named in a copy of BENCHMARK.json, run with no edit to the
    harness."""
    here = tmp_path / "benchmark"
    shutil.copytree(BENCH, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(here / "configs" / "cornell.py", here / "configs" / "cornell_floor.py")
    cfg = json.loads((here / "configs" / "cornell.json").read_text())
    cfg["scene"]["quad_light_plane"] = 5
    (here / "configs" / "cornell_floor.json").write_text(json.dumps(cfg))
    (here / "traffic" / "train_short.json").write_text(json.dumps({"kind": "train", "trace_seconds": 1}))
    (here / "limits" / "floor.train_short.json").write_text((here / "limits" / "cornell.train.json").read_text())
    (here / "metrics" / "jobs_per_window.py").write_text("def read(ctx):\n    return float(len(ctx.units))\n")
    spec = copy.deepcopy(harness.load_spec())
    spec["configs"].append({**spec["configs"][0], "name": "cornell_floor", "file": "benchmark/configs/cornell_floor.json"})
    spec["workloads"].append({"name": "floor.train_short", "config": "cornell_floor", "traffic": "train_short",
                              "chips": 1, "why": "a cell made of files alone"})
    spec["end_to_end"].append({"name": "jobs_per_window", "unit": "jobs", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["floor.train_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result = harness.run("floor.train_short", SEED, 0.3, False, "cpu", overrides=small("cornell.train"),
                         here=here, root=tmp_path)
    assert result["correct"] and result["metrics"]["jobs_per_window"]["value"] >= 1


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_and_units():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w[k] for w in spec["workloads"] for k in ("config", "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in spec["end_to_end"] + spec["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in spec["end_to_end"] + spec["per_layer"])
    for text in [c["source"] for c in spec["configs"]] + [x["why"] for x in spec["configs"] + spec["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for path in BENCH.rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.match(r"^[A-Za-z0-9_./-]+$", str(path.relative_to(ROOT))), path
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert all(w["chips"] == 1 for w in spec["workloads"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_card(card, workload):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(SEED),
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
