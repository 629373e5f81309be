"""The benchmark's plain reference: what the port's timed path must produce.

The sub-packages ``core``, ``geometry``, ``scenes``, ``utils``,
``integrator``, ``accel`` and the modules ``camera``, ``lights``, ``sky``,
``env``, ``textures`` and ``postprocess`` are frozen copies of the port's
plain PyTorch code at commit 930457f (each file's header names its
original), cut where the original would call a kernel or read a file
outside the checkout.  ``bvh`` builds the reference's own BVH, ``render``
traces sampled pixels across the frames of a request and replays the
renderer's accumulation and display, and ``train`` follows the first steps
of an inverse-rendering job with autograd and a plain Adam.

Nothing here imports ``bpt_tpu_torch``, ``bpt_tpu`` or ``jax``, and nothing
takes a table that the port made: the benchmark hands both sides the same
raw inputs and the reference derives the rest (BVH, targets) itself.
"""
