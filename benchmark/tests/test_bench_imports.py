"""What the benchmark loads, checked in fresh processes: the harness and
every configuration, traffic and metric file add no module whose top-level
name is jax, jaxlib, flax or bpt_tpu (compared whole: bpt_tpu_torch is the
port), and the reference adds none of those nor bpt_tpu_torch."""

import json
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_PROBE = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
before = set(sys.modules)
{body}
added = sorted(set(sys.modules) - before)
print(json.dumps(added))
"""

_HARNESS = r"""
from benchmark import harness, run, tracing, workcounts, generator, sides
spec = harness.load_spec()
for c in spec["configs"]:
    harness.load_module(harness.HERE / "configs" / (c["name"] + ".py"), "cfg_" + c["name"])
for m in spec["end_to_end"] + spec["per_layer"]:
    harness.metric_reader(m["name"])
# one small run of a cell of each traffic kind: the lazy imports of the port's entry points
small = {"config": {"size": 16, "train": {"param": "emission", "true": 10.0, "init": 4.0, "lr": 0.5, "steps": 2,
                                          "frames": 1, "clip": None}}}
harness.run("cornell.train", 5, 0.01, False, "cpu", overrides=small)
scene = json.load(open(harness.HERE / "configs" / "gltf_textured.json"))["scene"]
small = {"config": {"size": 16, "scene": {**scene, "heightfield_side": 4, "map_size": 16}},
         "traffic": {"spp": 2, "batch": 1, "checks": 1, "patches": 1, "warmup": 1}}
harness.run("textured.render", 5, 0.01, False, "cpu", overrides=small)
"""

_REFERENCE = r"""
import pkgutil, importlib, benchmark.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
"""


def _added(body: str) -> list:
    out = subprocess.run([sys.executable, "-c", _PROBE.format(body=body)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(modules) -> set:
    return {m.split(".")[0] for m in modules}


def test_harness_loads_no_jax_and_no_jax_package():
    added = _added(_HARNESS)
    assert "bpt_tpu_torch" in _tops(added)  # the run did drive the port
    assert not _tops(added) & {"jax", "jaxlib", "flax", "bpt_tpu"}


def test_reference_loads_neither_jax_nor_either_package():
    added = _added(_REFERENCE)
    assert not _tops(added) & {"jax", "jaxlib", "flax", "bpt_tpu", "bpt_tpu_torch"}


def test_no_file_reads_the_jax_benchmark_or_package():
    """No source under benchmark/ opens bench.py, BENCH_*.json or anything
    under bpt_tpu/, or imports bpt_tpu (the reference also never imports
    the port)."""
    opens = re.compile(r"(open|Path|read_text|load)\(.*(bench\.py|BENCH_|bpt_tpu/)")
    imports = re.compile(r"^\s*(from|import)\s+bpt_tpu(\.|\s|$)")
    port = re.compile(r"^\s*(from|import)\s+bpt_tpu_torch")
    for path in BENCH.rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not opens.search(line), (path, line)
            assert not imports.search(line), (path, line)
            if "reference" in path.relative_to(BENCH).parts:
                assert not port.search(line), (path, line)
