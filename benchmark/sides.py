"""What the benchmark hands each side: the port's types built from the
benchmark's own inputs, and cameras made the same way for both.

The benchmark builds every scene input with the reference's constructors
(frozen copies of the demos' data, ``benchmark.reference``) on the host;
``to_port`` rewraps those tensors in the port's NamedTuples of the same
names, so that the program and the reference start from the same values.
What the program derives from them (a mesh's BVH, its kernel tables, the
texel tables) it derives itself.
"""

from __future__ import annotations

import importlib


def to_port(obj):
    """A reference scene NamedTuple (``Scene``, ``Quads``, ``UnitSpheres``,
    ``Quadrics``, ``TriangleMesh``, ``Environment``, ``EnvCDF``) as the
    port's type of the same name, field by field; tensors are shared."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        for module in ("bpt_tpu_torch.scenes.types", "bpt_tpu_torch.env"):
            cls = getattr(importlib.import_module(module), type(obj).__name__, None)
            if cls is not None:
                return cls(*(to_port(x) for x in obj))
        raise TypeError(f"no port type named {type(obj).__name__}")
    return obj


def camera(camera_cls, spec: dict, position=None, yaw=None, pitch=None):
    """``camera_cls.look`` (the port's or the reference's ``Camera``) from
    a configuration's ``camera`` entry, with the view's position and angles
    where given, made on the host as a viewer makes it."""
    return camera_cls.look(position=spec["position"] if position is None else position,
                           yaw=spec["yaw"] if yaw is None else yaw, pitch=spec["pitch"] if pitch is None else pitch,
                           fov=spec["fov"], aperture_size=spec["aperture"], focus_distance=spec["focus"])


def integrator(config_cls, spec: dict):
    """``config_cls`` (the port's or the reference's ``IntegratorConfig``)
    from a configuration's ``integrator`` entry."""
    return config_cls(**spec["integrator"])
