"""Carry scenes, cameras, render state and parameters between the JAX package and the port.

The inputs are the JAX package's NamedTuples after
``jax.tree.map(np.asarray, x)``: fields are read by name from numpy arrays,
so this module imports no jax.  ``to_numpy`` goes the other way and returns
the port's NamedTuples with numpy fields, which the JAX types accept by
field name (``JaxType(**to_numpy(x)._asdict())``).
"""

from __future__ import annotations

import numpy as np
import torch

from bpt_tpu_torch.camera import Camera
from bpt_tpu_torch.renderer import RenderState
from bpt_tpu_torch.env import EnvCDF
from bpt_tpu_torch.scenes.types import Environment, Quadrics, Quads, Scene, TriangleMesh, UnitSpheres


def _tensor(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype).to(device)  # copy: jax-backed arrays are read-only


def _group(cls, src, device, fields=None):
    if src is None:
        return None
    return cls(**{name: None if getattr(src, name) is None else _tensor(getattr(src, name), device)
                  for name in fields or cls._fields})


#: The TriangleMesh fields carried across: the soup, the binary BVH, the
#: transform, the material and the four PBR maps (None where the JAX mesh
#: has none).  The JAX mesh's TPU packs (``pk_*``, ``fz_*``, the ``*_q``
#: quad-packed twins of the maps) are left behind, and the CUDA tables are
#: the port's own.
MESH_FIELDS = tuple(f for f in TriangleMesh._fields if f != "kernel_tables")


def _env(env, device):
    if env is None:
        return None
    fields = {name: _tensor(getattr(env, name), device) for name in ("sun_direction", "sun_power")}
    for name in ("hdr_image", "hdr_exposure"):
        if getattr(env, name, None) is not None:
            fields[name] = _tensor(getattr(env, name), device)
    if getattr(env, "env_cdf", None) is not None:
        fields["env_cdf"] = EnvCDF(*(_tensor(t, device) for t in env.env_cdf))
    return Environment(**fields)


def scene_from_numpy(scene_np, device=None) -> Scene:
    """A JAX ``Scene`` of numpy arrays -> the port's ``Scene`` on ``device``:
    quads, spheres, quadrics, the mesh (``MESH_FIELDS``) and the environment
    with its HDRI fields and CDF tables."""
    mesh = getattr(scene_np, "mesh", None)
    return Scene(quads=_group(Quads, scene_np.quads, device),
                 spheres=_group(UnitSpheres, scene_np.spheres, device),
                 quadrics=_group(Quadrics, getattr(scene_np, "quadrics", None), device),
                 mesh=_group(TriangleMesh, mesh, device, MESH_FIELDS),
                 env=_env(getattr(scene_np, "env", None), device))


def camera_from_numpy(camera_np, device=None) -> Camera:
    """A JAX ``Camera`` of numpy arrays -> the port's ``Camera``."""
    return Camera(**{name: _tensor(getattr(camera_np, name), device, torch.float32)
                     for name in Camera._fields})


def render_state_from_numpy(state_np, device=None) -> RenderState:
    """A JAX ``RenderState`` of numpy arrays -> the port's ``RenderState``
    (counters become host floats)."""
    return RenderState(accum=_tensor(state_np.accum, device, torch.float32),
                       sample_counter=float(state_np.sample_counter),
                       frame_counter=float(state_np.frame_counter))


def params_from_numpy(params_np: dict, device=None, requires_grad: bool = True) -> dict:
    """The JAX package's parameter pytree, a flat dict of numpy arrays (or
    scalars), -> the port's float32 leaf tensors on ``device``."""
    return {name: _tensor(v, device, torch.float32).requires_grad_(requires_grad) for name, v in params_np.items()}


def to_numpy(x):
    """The port's Scene / Camera / RenderState (or any NamedTuple of tensors)
    -> the same NamedTuple type with numpy fields; counters become float32."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, float):
        return np.float32(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    raise TypeError(f"cannot convert {type(x).__name__}")
