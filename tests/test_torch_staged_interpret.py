"""The port's plain staged driver against the JAX package's staged Pallas
path run in interpret mode, as its own tests run it: Cornell, 32x32, 2
bounces (two phases, one sort), by the bar of
``test_torch_integrator.assert_radiance_parity``.  A file of its own: the
two interpret-mode compilations take most of a minute.
"""

import jax.numpy as jnp
import numpy as np
import torch

from bpt_tpu.core.rng import blue_noise_table
from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.kernels.megakernel import trace_frames_pallas, trace_image_pallas
from bpt_tpu_torch.integrator import IntegratorConfig
from bpt_tpu_torch.kernels import megakernel
from bpt_tpu_torch.scenes.types import TRANSPARENT
from test_torch_integrator import _inputs, assert_radiance_parity

torch.set_num_threads(2)

BN = blue_noise_table()
TBN = torch.as_tensor(BN)
RV = np.array([0.3, 0.7], np.float32)
FRAMES = (2.0, 3.0)
RVS = (RV, np.array([0.6, 0.1], np.float32))


def test_staged_matches_jax_reorder_interpret():
    """The plain staged driver against JAX's staged Pallas kernel run in
    interpret mode, Cornell, 32x32, 2 bounces (two phases)."""
    (jscene, jcam), (tscene, tcam) = _inputs(TRANSPARENT)
    ref = trace_image_pallas(jscene, jcam, JConfig(bounces=2), 32, 32, 2.0, jnp.asarray(RV), jnp.asarray(BN),
                             tile_rows=32, interpret=True, reorder=True)
    got = megakernel.trace_image_fused(tscene, tcam, IntegratorConfig(bounces=2), 32, 32, 2.0, RV, TBN,
                                       reorder=True)
    assert_radiance_parity(got, ref)


def test_frames_match_jax_trace_frames_interpret():
    """trace_frames_fused against JAX's trace_frames_pallas (interpret),
    frames 2 and 3, Cornell, 32x32, 2 bounces, frame by frame."""
    (jscene, jcam), (tscene, tcam) = _inputs(TRANSPARENT)
    ref = trace_frames_pallas(jscene, jcam, JConfig(bounces=2), 32, 32, list(FRAMES), [list(rv) for rv in RVS],
                              jnp.asarray(BN), tile_rows=32, interpret=True)
    got = megakernel.trace_frames_fused(tscene, tcam, IntegratorConfig(bounces=2), 32, 32, FRAMES, RVS, TBN)
    for i in range(2):
        assert_radiance_parity(type(got)(*(t[i] for t in got)), type(ref)(*(np.asarray(t)[i] for t in ref)))
