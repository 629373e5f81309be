"""Row-tile sharding of the port over torch.distributed (gloo, the CPU),
against the port's single-process render and the JAX package.

The ports of tests/test_parallel.py:29,49,75,148 and
tests/test_multihost.py:67: 2 and 4 real processes each render their rows
of the 32x32 Cornell frame at 2 bounces through the unchanged entry points
(``sharded_render_frame``, the gradient of the light colour through
``replicate`` / ``sum_over_tiles``, ``sharded_screen_output``'s halo
exchange, a staged pool at the rank's ``row_offset``), and the 4-rank run
poses as 2 hosts x 2 (``LOCAL_WORLD_SIZE=2``) for ``host_row_range`` and the
hierarchical mesh.  The parent holds the concatenated tiles to the
single-process results bit for bit, the gradient to rtol 1e-5 (JAX's bar,
tests/test_parallel.py:71) and the frame to JAX's ``render_frame`` within
tests/test_parallel.py's rtol 1e-4, atol 1e-5.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.integrator.frame import render_frame as j_render_frame
from bpt_tpu.integrator.frame import trace_image as j_trace_image
from bpt_tpu.scenes.cornell import cornell_camera as j_cornell_camera
from bpt_tpu.scenes.cornell import cornell_scene as j_cornell_scene
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.integrator.frame import render_frame, trace_image
from bpt_tpu_torch.kernels.megakernel import trace_frames_fused
from bpt_tpu_torch.postprocess import screen_output
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene
from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model
from bpt_tpu_torch.scenes.types import DIFFUSE
from test_torch_kernels import blob_model

torch.set_num_threads(2)

H, W = 32, 32
BN = blue_noise_table()
TBN = torch.as_tensor(BN)
RV = np.array([0.3, 0.7], np.float32)
CFG = IntegratorConfig(bounces=2)

BOX = dict(rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5), translation=(0.0, -20.0, -85.0))


def _tile_cases():
    """Cornell (its quads by either test) and the 64-triangle blob, where
    the camera sees it, through the plain walk."""
    return {"cornell": (cornell_scene(), cornell_camera(), {}),
            "cornell-parallelogram": (cornell_scene(), cornell_camera(), {"fast_quads": True}),
            "blob": (gltf_scene(mesh_from_model(blob_model(64), mat_type=DIFFUSE, **BOX)), gltf_camera(),
                     {"plain_walk": True})}


@pytest.mark.parametrize("case", ["cornell", "cornell-parallelogram", "blob"])
def test_row_tile_equals_rows_of_the_whole_frame(case):
    """trace_image(tile_rows, row_offset): rows [12, 20) of a 32x16 film
    equal those rows of the whole frame bit for bit, in its forward, its
    param_grads planes and its lane counts' first-bounce lanes."""
    scene, cam, kw = _tile_cases()[case]
    whole = trace_image(scene, cam, CFG, 16, 32, 2.0, RV, TBN, **kw)
    tile = trace_image(scene, cam, CFG, 16, 32, 2.0, RV, TBN, tile_rows=8, row_offset=12, **kw)
    for a, b in zip(tile, whole):
        torch.testing.assert_close(a, b[12:20], rtol=0, atol=0)
    counts_whole, counts_tile = [], []
    g_whole = trace_image(scene, cam, CFG, 16, 32, 2.0, RV, TBN, param_grads=True, lane_counts=counts_whole, **kw)
    g_tile = trace_image(scene, cam, CFG, 16, 32, 2.0, RV, TBN, param_grads=True, lane_counts=counts_tile,
                         tile_rows=8, row_offset=12, **kw)
    for a, b in zip(g_tile[0], g_whole[0]):
        torch.testing.assert_close(a, b[12:20], rtol=0, atol=0)
    torch.testing.assert_close(g_tile[1], g_whole[1][:, 12:20], rtol=0, atol=0)
    assert int(counts_tile[0].live) == 8 * 16 and int(counts_whole[0].live) == 32 * 16
    if case == "blob":
        assert int(counts_tile[0].tri_tests) > 0  # the tile's rays reach the mesh
    with pytest.raises(ValueError, match="rows"):
        trace_image(scene, cam, CFG, 16, 32, 2.0, RV, TBN, tile_rows=8, row_offset=28, **kw)


def test_row_tile_matches_jax():
    """The port's tile against JAX's trace_image(tile_rows, row_offset) on
    the same rows, within tests/test_parallel.py's bar."""
    ref = j_trace_image(j_cornell_scene(), j_cornell_camera(), JConfig(bounces=2), 16, 32, 2.0, jnp.asarray(RV),
                        jnp.asarray(BN), tile_rows=8, row_offset=12)
    got = trace_image(cornell_scene(), cornell_camera(), CFG, 16, 32, 2.0, RV, TBN, tile_rows=8, row_offset=12)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


_WORKER = r"""
import os, sys
import numpy as np
import torch

torch.set_num_threads(1)
rank, world, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]

from bpt_tpu_torch.parallel.multihost import host_row_range, initialize, make_multihost_mesh

initialize(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, device="cpu")
initialize(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, device="cpu")  # idempotent

from bpt_tpu_torch.core.rng import blue_noise_table
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.kernels.megakernel import trace_frames_fused
from bpt_tpu_torch.parallel import (make_mesh, sharded_render_frame, sharded_screen_output, sharded_trace,
                                    sum_over_tiles, tile_rows)
from bpt_tpu_torch.scenes.cornell import cornell_camera, cornell_scene

H, W = 32, 32
mesh = make_multihost_mesh()
cfg = IntegratorConfig(bounces=2)
scene, cam = cornell_scene(), cornell_camera()
bn = torch.as_tensor(blue_noise_table())
rv = np.array([0.3, 0.7], np.float32)
rows, r0 = tile_rows(H, mesh)
prev = torch.zeros((rows, W, 4))
out = {"frame": sharded_render_frame(scene, cam, cfg, prev, 2.0, False, rv, bn, mesh),
       "trace": sharded_trace(scene, cam, cfg, H, W, 2.0, rv, bn, mesh).color}

lc = torch.tensor([10.0, 10.0, 10.0], requires_grad=True)
lit = scene._replace(quads=scene.quads._replace(color=torch.cat([scene.quads.color[:5], lc[None]])))
frame = sharded_render_frame(lit, cam, cfg, prev, 2.0, False, rv, bn, mesh)
loss = sum_over_tiles(frame[..., :3].sum(), mesh) / (H * W * 3)
loss.backward()
out["loss"], out["grad"] = loss.detach(), lc.grad

acc = prev
for f in range(3):
    acc = sharded_render_frame(scene, cam, cfg, acc, float(f + 1), False, rv, bn, mesh)
out["display"] = sharded_screen_output(acc, 1.0 / 3.0, mesh)
out["pool"] = trace_frames_fused(scene, cam, cfg, W, rows, (2.0,), (rv,), bn, full_height=H, row_offset=r0).color[0]
out["host_rows"] = torch.tensor(host_row_range(H, mesh))
out["rows"] = torch.tensor([r0, r0 + rows])
grid = make_multihost_mesh(hierarchical=True)
out["grid"] = torch.tensor(list(grid.shape))
assert grid.mesh_dim_names == ("hosts", "chips")
try:
    host_row_range(H + 1, mesh)
    raise SystemExit("host_row_range took a remainder")
except ValueError:
    pass
torch.save({k: v.detach() for k, v in out.items()}, os.path.join(outdir, f"rank{rank}.pt"))
"""


def _run(world: int, local_world: int, tmp) -> list:
    """``world`` gloo ranks of the worker; their saved tensors, by rank."""
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(local_world), OMP_NUM_THREADS="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), port, str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    try:
        outs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:  # a rank that hangs must not outlive the test
            p.kill()
            p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank run (one rank a host) and the 4-rank run (2 hosts x 2)."""
    return {2: _run(2, 1, tmp_path_factory.mktemp("ranks2")), 4: _run(4, 2, tmp_path_factory.mktemp("ranks4"))}


@pytest.fixture(scope="module")
def single():
    """The single-process results the ranks are held to."""
    scene, cam = cornell_scene(), cornell_camera()
    prev = torch.zeros((H, W, 4))
    lc = torch.tensor([10.0, 10.0, 10.0], requires_grad=True)
    lit = scene._replace(quads=scene.quads._replace(color=torch.cat([scene.quads.color[:5], lc[None]])))
    loss = render_frame(lit, cam, CFG, prev, 2.0, False, RV, TBN)[..., :3].mean()
    loss.backward()
    acc = prev
    for f in range(3):
        acc = render_frame(scene, cam, CFG, acc, float(f + 1), False, RV, TBN)
    return {"frame": render_frame(scene, cam, CFG, prev, 2.0, False, RV, TBN),
            "trace": trace_image(scene, cam, CFG, W, H, 2.0, RV, TBN).color,
            "loss": loss.detach(), "grad": lc.grad, "accum": acc, "display": screen_output(acc, 1.0 / 3.0),
            "pool": trace_frames_fused(scene, cam, CFG, W, H, (2.0,), (RV,), TBN).color[0]}


def _joined(ranks, key):
    return torch.cat([r[key] for r in ranks])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_render_frame_equals_single_process(runs, single, world):
    """Each rank's rows of sharded_render_frame and sharded_trace, joined,
    equal the single-process frame bit for bit."""
    ranks = runs[world]
    assert [r["rows"].tolist() for r in ranks] == [[i * H // world, (i + 1) * H // world] for i in range(world)]
    torch.testing.assert_close(_joined(ranks, "frame"), single["frame"], rtol=0, atol=0)
    torch.testing.assert_close(_joined(ranks, "trace"), single["trace"], rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_render_frame_matches_jax(runs, world):
    """The joined frame against JAX's single-device render_frame, within
    tests/test_parallel.py's bar."""
    ref = j_render_frame(j_cornell_scene(), j_cornell_camera(), JConfig(bounces=2), jnp.zeros((H, W, 4)), 2.0,
                         False, jnp.asarray(RV), jnp.asarray(BN))
    np.testing.assert_allclose(_joined(runs[world], "frame").numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gradient_is_summed_over_ranks(runs, single, world):
    """Every rank's gradient of the mean frame in the light colour equals the
    single-process gradient (rtol 1e-5), and every rank sees the whole
    loss."""
    assert single["grad"].abs().sum() > 0
    for r in runs[world]:
        torch.testing.assert_close(r["grad"], single["grad"], rtol=1e-5, atol=0)
        torch.testing.assert_close(r["loss"], single["loss"], rtol=1e-6, atol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_screen_output_halo_exchange(runs, single, world):
    """sharded_screen_output over a 3-frame buffer equals screen_output of
    the whole film exactly (the 2-row halos gathered from the neighbours,
    clamped at the film's own edges only); each tile's own screen_output,
    clamped at the tile's edges, does not."""
    torch.testing.assert_close(_joined(runs[world], "display"), single["display"], rtol=0, atol=0)
    clamped = torch.cat([screen_output(t, 1.0 / 3.0) for t in single["accum"].chunk(world)])
    assert not torch.equal(clamped, single["display"])


@pytest.mark.parametrize("world", [2, 4])
def test_staged_pools_at_row_offsets_equal_the_whole_frame(runs, single, world):
    """trace_frames_fused pools of each rank's rows at its row_offset (the
    plain phases on the CPU) equal the whole frame's pool bit for bit: the
    kernel route of tests/test_parallel.py:75."""
    torch.testing.assert_close(_joined(runs[world], "pool"), single["pool"], rtol=0, atol=0)


@pytest.mark.parametrize("world,hosts", [(2, 2), (4, 2)])
def test_host_row_range_and_hierarchical_mesh(runs, world, hosts):
    """tests/test_multihost.py:67's checks: each host owns the contiguous
    rows of its ranks, the (hosts, chips) mesh has the host grid's shape,
    and a height that does not divide raises."""
    per_host = world // hosts
    for rank, r in enumerate(runs[world]):
        host = rank // per_host
        assert r["host_rows"].tolist() == [host * H // hosts, (host + 1) * H // hosts]
        assert r["grid"].tolist() == [hosts, per_host]
