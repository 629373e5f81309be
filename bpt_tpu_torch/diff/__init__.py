"""Inverse rendering (port of ``bpt_tpu.diff``): parameter gradients of the
render and the Adam loop that recovers scene parameters from a target.

Two routes carry gradients.  The fused one, ``trace_image_fused(...,
differentiable=True)``, is the path-replay VJP of the CUDA kernel's grads
mode (material and emission colors, and through the deferred composition
the HDR map, its exposure and the albedo and emissive maps).  The wavefront
one, ``make_render_loss``, is autograd through ``trace_image`` (a mesh's
walk through the closest-hit query's recompute VJP) and reaches the camera
and the geometry too.  The boundary-gradient terms
(``diff/silhouette.py``, ``diff/shadow.py`` in the JAX package) are not
ported yet.
"""

from bpt_tpu_torch.diff.gradients import finite_difference, make_render_loss, value_and_param_grads
from bpt_tpu_torch.diff.inverse import OptimizeResult, optimize, render_avg
