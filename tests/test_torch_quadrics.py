"""The port's twelve unit-quadric intersectors against the JAX package's.

4096 object-space rays made from a numpy seed: most aimed from a sphere of
radius 3 at random points of the unit cube, a quarter in random directions,
an eighth starting inside the cube.  Bar, per shape and shape parameter:
hit/miss equal on every ray; t within rtol 1e-5 where both hit; the
unnormalized normals within rtol 1e-4 (atol 1e-6 of the largest normal
component, which only matters for components near 0).  Measured: t within
3.6e-6, normals within 1e-6 relative to their scale.  The torus's normal is
the 4-tap finite difference of its SDF (taps 1.15e-4 apart, length 5.3e-8),
whose components cancel in float32 (up to 33% on a small component): it is
held after normalization, within atol 1e-3 (measured 5.0e-4), which is the
normal the integrator uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.geometry import quadrics as jq
from bpt_tpu_torch.geometry import quadrics as tq

torch.set_num_threads(2)

N_RAYS = 4096
NAMES = [name for name, _ in tq.UNIT_INTERSECTORS]


def _rays(seed=7):
    gen = np.random.default_rng(seed)
    o = gen.normal(size=(N_RAYS, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = gen.uniform(-1.0, 1.0, (N_RAYS, 3)) - o
    idx = np.arange(N_RAYS)
    d = np.where((idx % 4 == 0)[:, None], gen.normal(size=(N_RAYS, 3)), d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.where((idx % 8 == 1)[:, None], gen.uniform(-0.9, 0.9, (N_RAYS, 3)), o)
    return o.astype(np.float32), d.astype(np.float32)


RO, RD = _rays()


def test_intersector_order_matches_jax():
    assert NAMES == [name for name, _ in jq.UNIT_INTERSECTORS]


@pytest.mark.parametrize("k", [0.35, 0.5, 0.9])
@pytest.mark.parametrize("shape", range(12), ids=NAMES)
def test_unit_intersector_matches_jax(shape, k):
    _, jfn = jq.UNIT_INTERSECTORS[shape]
    _, tfn = tq.UNIT_INTERSECTORS[shape]
    jt, jn = jfn(jnp.asarray(RO), jnp.asarray(RD), jnp.float32(k))
    tt, tn = tfn(torch.as_tensor(RO), torch.as_tensor(RD), torch.tensor(k))
    jt, jn, tt, tn = np.asarray(jt), np.asarray(jn), tt.numpy(), tn.numpy()
    hit = jt < 1.0e6
    np.testing.assert_array_equal(tt < 1.0e6, hit)
    assert hit.sum() > N_RAYS // 8, "too few hits to test"
    np.testing.assert_array_equal(tt[~hit], jt[~hit])
    np.testing.assert_allclose(tt[hit], jt[hit], rtol=1e-5)
    if NAMES[shape] == "torus":
        def unit(n):
            return n / np.linalg.norm(n, axis=-1, keepdims=True)

        np.testing.assert_allclose(unit(tn[hit]), unit(jn[hit]), rtol=0, atol=1e-3)
    else:
        scale = np.abs(jn[hit]).max()
        np.testing.assert_allclose(tn[hit], jn[hit], rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.parametrize("k", [0.35, 0.5, 0.9])
def test_torus_early_stop_is_the_full_march(k):
    """The plain march stops once no lane marches (checked every 32 steps);
    its result is bit-equal to the reference's fixed 500 steps, and the step
    counts it reports stay within the 500."""
    ro, rd, kk = torch.as_tensor(RO), torch.as_tensor(RD), torch.tensor(k)
    steps = []
    t_early, n_early = tq.unit_torus_intersect(ro, rd, kk, steps_out=steps)
    t_full, n_full = tq.unit_torus_intersect(ro, rd, kk, check_every=None)
    assert torch.equal(t_early, t_full) and torch.equal(n_early, n_full)
    assert (t_full < 1.0e6).any()
    assert int(steps[0].max()) <= tq.TORUS_MAX_STEPS and int(steps[0].sum()) > 0
