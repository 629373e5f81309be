"""The port's K5 (the walk-loop cost microbenchmark), its tool and its
profiling module against the JAX package on the CPU.

``tools/loop_cost.py``'s Pallas kernel runs in interpret mode with the
VMEM specs of its ``run``; the port's wrapper runs its plain version on CPU
tensors.  Both must agree bit for bit: XLA contracts ``v * r + 1e-7`` into
one FMA, which the plain version rounds exactly (see
``bpt_tpu_torch/kernels/loop_cost.py``).
"""

import importlib.util
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bpt_tpu.utils import profiling as jax_profiling
from bpt_tpu_torch.kernels import loop_cost as k5
from bpt_tpu_torch.tools import loop_cost as tool
from bpt_tpu_torch.utils import profiling

_spec = importlib.util.spec_from_file_location("jax_loop_cost_tool",
                                               Path(__file__).resolve().parents[1] / "tools" / "loop_cost.py")
_jax_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_jax_tool)
make_kernel = _jax_tool.make_kernel  # tools/loop_cost.py, the JAX tool

torch.set_num_threads(2)


def jax_loop_cost(tab, x, n_iter, n_ops, use_reduce, use_cond):
    """The JAX tool's kernel in interpret mode, with ``run``'s specs."""
    fn = pl.pallas_call(
        make_kernel(n_iter, n_ops, use_reduce, use_cond, x.shape),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(tab), jnp.asarray(x)))


def seeded_inputs(seed=0):
    """x in [0.5, 1.5]; a table near 1 whose rows either grow the tile or,
    about half of them, shrink it, so that the max takes either side and
    the any-reduce is set in some iterations and clear in others."""
    rng = np.random.default_rng(seed)
    shrink = np.where(rng.random((64, 1)) < 0.5, -2e-3, 0.0)
    tab = (1.0 + rng.uniform(-1e-3, 1e-3, (64, 128)) + shrink).astype(np.float32)
    x = rng.uniform(0.5, 1.5, k5.TILE).astype(np.float32)
    return tab, x


@pytest.mark.parametrize("config", k5.CONFIGS, ids=lambda c: "ops{}-reduce{:d}-cond{:d}".format(*c))
def test_loop_cost_matches_jax_interpret(config):
    """Bit for bit in every configuration of the tool's main, 20 iterations
    (320 ops: 8); with the reduce, its flag is both set and clear."""
    n_ops, use_reduce, use_cond = config
    n_iter = 8 if n_ops == 320 else 20
    tab, x = seeded_inputs()
    ref = jax_loop_cost(tab, x, n_iter, *config)
    got = k5.loop_cost(torch.from_numpy(tab), torch.from_numpy(x), n_iter, *config).numpy()
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(got, ref)
    if n_ops:
        assert (got != x).any()
    if use_reduce:
        flags = []
        k5.loop_cost_reference(torch.from_numpy(tab), torch.from_numpy(x), n_iter, *config, flags=flags)
        assert len(flags) == n_iter and 0 < sum(bool(f) for f in flags) < n_iter


def nearest_f32(exact) -> np.float32:
    """The float32 nearest to a Fraction, ties to even."""
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda g: (abs(Fraction(float(g)) - exact), int(g.view(np.int32)) & 1))


def test_fma_f32_rounds_once():
    """fma_f32 is a correctly rounded float32 FMA: against exact rationals
    on seeded values, and on a sum just above a float32 midpoint, where a
    float64 sum rounded to float32 rounds twice and goes wrong."""
    rng = np.random.default_rng(1)
    v = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    r = rng.uniform(0.5, 2.0, 256).astype(np.float32)
    c = float(np.float32(1e-7))
    got = k5.fma_f32(torch.from_numpy(v), torch.from_numpy(r), c).numpy()
    for a, b, g in zip(v, r, got):
        assert g == nearest_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(c))
    a = torch.tensor([1.0 + 2.0 ** -12])  # a * a = 1 + 2^-11 + 2^-24, a float32 midpoint
    tiny = 2.0 ** -60
    want = np.float32(1.0 + 2.0 ** -11 + 2.0 ** -23)
    assert k5.fma_f32(a, a, tiny).item() == want
    assert (a.double() * a.double() + tiny).float().item() != want


def test_tool_inputs_match_the_jax_tool():
    """The tool's table and tile inputs are the JAX tool's, bit for bit."""
    tab = jnp.arange(64 * 128, dtype=jnp.float32).reshape(64, 128) * 1e-6 + 1.0
    np.testing.assert_array_equal(tool.table(), np.asarray(tab))
    for i in range(tool.TIMED_CALLS):
        np.testing.assert_array_equal(tool.tile_input(i), np.asarray(jnp.ones((8, 256), jnp.float32)
                                                                      + jnp.float32(i) * 1e-6))


def test_tool_needs_a_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    """No --device means the card, and raises without one; --device cpu
    runs the plain version over the JAX tool's seven configurations and
    prints its lines."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--iters", "2"])
    results = tool.main(["--iters", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    assert [r["config"] for r in results] == list(k5.CONFIGS)
    for line, (n_ops, red, cond) in zip(lines[1:], k5.CONFIGS):
        assert re.fullmatch(rf"tile=\(8, 256\) ops={n_ops:4d} reduce={int(red)} cond={int(cond)}: +[0-9.]+ ns/iter"
                            r"  \([0-9.]+ ms total\)", line), line
    tab = tool.table()
    x = tool.tile_input(tool.TIMED_CALLS - 1)
    for r in results:
        np.testing.assert_array_equal(r["out"].numpy(), jax_loop_cost(tab, x, 1, *r["config"]))


def test_loop_cost_refuses_bad_inputs():
    tab, x = (torch.from_numpy(a) for a in seeded_inputs())
    with pytest.raises(TypeError, match="float32"):
        k5.loop_cost(tab.double(), x, 1, 40, False, False)
    with pytest.raises(ValueError, match=r"\(8, 256\)"):
        k5.loop_cost(tab, x[:4], 1, 40, False, False)
    with pytest.raises(ValueError, match="contiguous"):
        k5.loop_cost(tab, x.t().contiguous().t(), 1, 40, False, False)
    with pytest.raises(ValueError, match="n_iter"):
        k5.loop_cost(tab, x, -1, 40, False, False)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        k5.loop_cost(tab.to("meta"), x.to("meta"), 1, 40, False, False)
    with pytest.raises(ValueError, match="tab is on"):
        k5.loop_cost(tab.to("meta"), x, 1, 40, False, False)


def test_frame_stats_and_profiler_match_jax(monkeypatch, tmp_path):
    """FrameStats and Profiler against bpt_tpu.utils.profiling on one tick
    sequence and one clock: fps, rays/s, the 60-frame window, the summary's
    lines; device_trace writes a Chrome trace."""
    rng = np.random.default_rng(2)
    ticks = rng.uniform(0.005, 0.05, 75).tolist()
    ours, theirs = profiling.FrameStats(), jax_profiling.FrameStats()
    assert ours.fps == theirs.fps == 0.0 and ours.rays_per_second(10) == theirs.rays_per_second(10) == 0.0
    for i, t in enumerate(ticks):
        ours.tick(t)
        theirs.tick(t)
        assert ours.times == theirs.times and len(ours.times) == min(i + 1, 60)
        assert ours.fps == theirs.fps
        assert ours.rays_per_second(1024 * 1024 * 4) == theirs.rays_per_second(1024 * 1024 * 4)

    stamps = np.cumsum(rng.uniform(0.001, 0.01, 40)).tolist()
    summaries = []
    for module in (profiling, jax_profiling):
        it = iter(stamps)
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))
        prof = module.Profiler()
        for i in range(6):
            with prof.section("render", rays=256 * 256 * 4):
                pass
            if i % 2:
                with prof.section("display"):
                    pass
        summaries.append((prof.summary(), prof.sections, prof.rays))
    assert summaries[0] == summaries[1]
    assert summaries[0][0].splitlines()[0].startswith("render: ") and "Mrays/s" in summaries[0][0]
    monkeypatch.undo()

    with profiling.device_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))
