"""Inverse rendering (port of ``bpt_tpu.diff``): parameter gradients of the
render and the Adam loop that recovers scene parameters from a target.

Two routes carry gradients.  The fused one, ``trace_image_fused(...,
differentiable=True)``, is the path-replay VJP of the CUDA kernel's grads
mode (material and emission colors, and through the deferred composition
the HDR map, its exposure and the albedo and emissive maps).  The wavefront
one, ``make_render_loss``, is autograd through ``trace_image`` (a mesh's
walk through the closest-hit query's recompute VJP) and reaches the camera
and the geometry too.  Neither sees the jump of a moving edge: the
boundary terms of a sphere's silhouette (``diff.silhouette``) and of its
shadow under the quad light (``diff.shadow``) add it, in plain torch.
"""

from bpt_tpu_torch.diff.gradients import finite_difference, make_render_loss, value_and_param_grads
from bpt_tpu_torch.diff.inverse import OptimizeResult, optimize, render_avg
