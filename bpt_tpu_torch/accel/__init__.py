"""BVH build (host, numpy or native C++) and the plain per-lane walk.

``accel.traverse`` is imported by ``integrator.intersect`` when a scene
carries a mesh.
"""

from bpt_tpu_torch.accel.builder import BuiltBVH, build_bvh, build_bvh_sah, triangle_aabbs
