"""The frozen roofline counts (benchmark/work/roofline.py) against counts
worked out by hand for small cases."""

from typing import NamedTuple

import pytest
import torch

from benchmark.work import roofline

BLUE_NOISE_BYTES = 256 * 256 * 4 * 4  # the decision table, read once
PARAMS_BYTES = 4 * (16 + 24)  # camera 16 floats, parameters 24


class Lanes(NamedTuple):
    live: int
    hits: int
    misses: int
    torus_steps: int = 0
    node_visits: int = 0
    tri_tests: int = 0
    shadow_misses: int = 0
    mesh_reads: tuple | None = None
    pbr_classes: torch.Tensor | None = None
    emissive_hits: int = 0
    lobe_draws: int = 0
    texel_samples: torch.Tensor | None = None
    texel_reads: tuple | None = None
    parallelogram_tests: int = 0


def test_one_quad_by_hand():
    # 4 pixels, one bounce: 3 live lanes, 2 hits; one quad tested by the two fans
    flop, nbytes = roofline.kernel_work([Lanes(live=3, hits=2, misses=1)], n_quads=1, n_spheres=0, pixels=4)
    assert flop == 4 * 80 + 3 * 104 + 2 * 24
    assert nbytes == BLUE_NOISE_BYTES + PARAMS_BYTES + 4 * 32 + 11 * 4 * 4


def test_parallelogram_test_by_hand():
    # the same lanes with the parallelogram test: 34 a test and the per-quad algebra (50) once
    flop, _ = roofline.kernel_work([Lanes(live=3, hits=2, misses=1, parallelogram_tests=3)], n_quads=1,
                                   n_spheres=0, pixels=4)
    assert flop == 4 * 80 + 3 * 34 + 50 + 2 * 24
    fans, _ = roofline.kernel_work([Lanes(live=3, hits=2, misses=1, parallelogram_tests=3)], n_quads=1,
                                   n_spheres=0, pixels=4, as_fans=True)
    assert fans == 4 * 80 + 3 * 104 + 2 * 24


def test_spheres_and_two_bounces_by_hand():
    lanes = [Lanes(live=4, hits=3, misses=1), Lanes(live=2, hits=1, misses=1)]
    flop, nbytes = roofline.kernel_work(lanes, n_quads=2, n_spheres=1, pixels=4)
    assert flop == 4 * 80 + 6 * 1 * 68 + 6 * 2 * 104 + 4 * 24
    assert nbytes == BLUE_NOISE_BYTES + PARAMS_BYTES + 4 * (2 * 32 + 24) + 11 * 4 * 4


def test_mesh_records_by_hand():
    # one live lane walks 2 inner nodes and tests 3 triangles; it read 3 node boxes, 3 triangles, 1 normal record
    reads = (torch.tensor([True, True, False, True]), torch.tensor([True, True, True, False]),
             torch.tensor([False, True, False, False]))
    lanes = [Lanes(live=1, hits=1, misses=0, node_visits=2, tri_tests=3, mesh_reads=reads)]
    flop, nbytes = roofline.kernel_work(lanes, n_quads=0, n_spheres=0, pixels=1, mesh=True)
    assert flop == 80 + 48 + 2 * 24 + 3 * 52 + 24
    assert nbytes == BLUE_NOISE_BYTES + PARAMS_BYTES + 11 * 4 + 4 * 17 + 3 * 32 + 3 * 48 + 1 * 48


def test_staged_pool_by_hand():
    # 2 frames of 4 pixels in one pool, two bounces: one boundary with 5 live lanes
    lanes = [Lanes(live=8, hits=6, misses=2), Lanes(live=5, hits=4, misses=1)]
    flop, nbytes = roofline.staged_work(lanes, frames=2, lanes=8, pixels=4, n_quads=1, n_spheres=0)
    k_flop, k_bytes = roofline.kernel_work(lanes, n_quads=1, n_spheres=0, pixels=8)
    assert flop == k_flop == 8 * 80 + 13 * 104 + 10 * 24
    assert nbytes == k_bytes + 2 * 56 * 5 + 4 * 8


def test_staged_scale_by_hand():
    # counts of one frame of a 3-frame pool: operations x 3, the other frames' planes written, live lanes x 3
    lanes = [Lanes(live=4, hits=4, misses=0), Lanes(live=2, hits=1, misses=1)]
    flop, nbytes = roofline.staged_work(lanes, frames=3, lanes=12, scale=3, pixels=4, n_quads=1, n_spheres=0)
    one_flop, one_bytes = roofline.kernel_work(lanes, n_quads=1, n_spheres=0, pixels=4)
    assert flop == 3 * one_flop
    assert nbytes == one_bytes + 2 * 11 * 4 * 4 + 2 * 56 * 3 * 2 + 4 * 12


def test_grad_planes_by_hand():
    sg = torch.tensor([[[2.0, 1.0]], [[0.0, 3.0]], [[0.0, 0.5]], [[0.0, 0.0]]])  # 2 objects: counts, then refractions
    flop, nbytes = roofline.grad_planes_work(sg, n_obj=2, n_deferred=1, lanes=2)
    assert flop == (2 + 1 + 3) + 2 * 1
    assert nbytes == 4 * 2 * (4 + 1)


@pytest.mark.parametrize("flop,nbytes,by", [(67e9, 1.0, "operations"), (1.0, 3.35e9, "bytes")])
def test_bound_is_the_larger_time(flop, nbytes, by):
    ms, which = roofline.bound(flop, nbytes)
    assert which == by and ms == pytest.approx(1.0)
