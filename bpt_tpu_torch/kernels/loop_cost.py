"""K5, the walk-loop cost microbenchmark: CUDA kernel wrapper and plain version.

Port of the Pallas kernel of ``tools/loop_cost.py`` (``make_kernel``, run by
``run``).  One (8, 256) float32 tile goes ``n_iter`` times round a loop whose
body is the walk loop's building blocks: a scalar-indexed load of table row
``i % 64``, a dependent chain of ``n_ops`` steps ``v = max(v * row[k % 128]
+ 1e-7, v * 0.99995)``, and optionally a tile-wide ``any(v > acc)`` (``acc``
the tile at the start of the iteration) that scales the tile by 0.9999 by a
branch (``use_cond``) or a select.  ``use_cond`` without ``use_reduce`` does
nothing, as in the JAX tool.

XLA fuses ``v * r + 1e-7`` into one fused multiply-add, rounded once; the
kernel calls ``__fmaf_rn`` for it and multiplies everything else without
contraction (``--fmad=false``).  The plain version computes the product
exactly in float64 (two 24-bit significands fit in 53 bits), adds the
constant rounded to odd (an exact TwoSum picks the neighbour with an odd last
bit where the sum was inexact) and rounds that to float32: a correctly
rounded FMA, so both versions and JAX agree bit for bit.  The constants are
the float32 roundings of JAX's weakly typed Python floats.

``loop_cost(tab, x, n_iter, n_ops, use_reduce, use_cond)`` launches the
kernel on CUDA tensors (one block; ``CONFIGS`` lists the instantiations)
and runs ``loop_cost_reference`` on CPU tensors.  A failed build or launch,
a configuration without an instantiation, or a tensor of another dtype,
shape or device raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from bpt_tpu_torch.kernels import build

KERNEL = "loop_cost"
TAB_SHAPE = (64, 128)
TILE = (8, 256)
#: (n_ops, use_reduce, use_cond) of each instantiation in csrc/loop_cost.cu:
#: the seven configurations of the tool.
CONFIGS = ((0, False, False), (40, False, False), (100, False, False), (320, False, False),
           (40, True, False), (40, True, True), (320, True, True))
#: Launches of the kernel per configuration.
LAUNCHES = {c: 0 for c in CONFIGS}

ADD = float(np.float32(1.0e-7))
DECAY = float(np.float32(0.99995))
SCALE = float(np.float32(0.9999))


def reset_launches() -> None:
    """Set every launch count to 0."""
    for c in LAUNCHES:
        LAUNCHES[c] = 0


def fma_f32(v: torch.Tensor, r: torch.Tensor, c: float) -> torch.Tensor:
    """``v * r + c`` rounded once to float32 (v, r float32; c a float32
    value): the exact product in float64, the sum rounded to odd, then to
    float32."""
    p = v.double() * r.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # TwoSum: s + err == p + c exactly
    inexact_even = ((err > 0) | (err < 0)) & ((s.view(torch.int64) & 1) == 0)  # NaN err (s infinite): no fix
    s = torch.where(inexact_even, torch.nextafter(s, err.sign() * math.inf), s)
    return s.float()


def loop_cost_reference(tab: torch.Tensor, x: torch.Tensor, n_iter: int, n_ops: int, use_reduce: bool,
                        use_cond: bool, flags: list | None = None) -> torch.Tensor:
    """The plain PyTorch version: the loop step by step on the tile.  With
    ``use_reduce``, ``flags`` (a list) collects each iteration's any-reduce,
    a bool tensor."""
    decay = torch.tensor(DECAY, dtype=torch.float32, device=x.device)
    scale = torch.tensor(SCALE, dtype=torch.float32, device=x.device)
    v = x
    for i in range(n_iter):
        row = tab[i % 64]
        acc = v
        for k in range(n_ops):
            v = torch.maximum(fma_f32(v, row[k % 128], ADD), v * decay)
        if use_reduce:
            flag = (v > acc).any()
            v = torch.where(flag, v * scale, v)  # lax.cond and jnp.where give the same values
            if flags is not None:
                flags.append(flag)
    return v


def _library() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    p = ctypes.c_void_p
    lib.bpt_loop_cost.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
    lib.bpt_loop_cost.restype = ctypes.c_int
    return lib


def _check(tab: torch.Tensor, x: torch.Tensor, n_iter: int) -> None:
    for name, t, shape in (("tab", tab, TAB_SHAPE), ("x", x, TILE)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tab.device != x.device:
        raise ValueError(f"tab is on {tab.device}, x on {x.device}")
    if not 0 <= n_iter < 2 ** 31:
        raise ValueError(f"n_iter must be in [0, 2**31), got {n_iter}")


def loop_cost(tab: torch.Tensor, x: torch.Tensor, n_iter: int, n_ops: int, use_reduce: bool,
              use_cond: bool) -> torch.Tensor:
    """The tile after ``n_iter`` iterations: the kernel on the tensors' card,
    the plain version on the CPU."""
    _check(tab, x, n_iter)
    config = (n_ops, bool(use_reduce), bool(use_cond))
    if x.device.type == "cpu":
        return loop_cost_reference(tab, x, n_iter, *config)
    if x.device.type != "cuda":
        raise ValueError(f"tensors must be on the CPU or a CUDA device, got {x.device}")
    if config not in LAUNCHES:
        raise ValueError(f"no kernel instantiation for (n_ops, use_reduce, use_cond) = {config}; "
                         f"csrc/loop_cost.cu has {CONFIGS}")
    out = torch.empty_like(x)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bpt_loop_cost(tab.data_ptr(), x.data_ptr(), out.data_ptr(), n_iter, *config, stream)
    if err != 0:
        raise RuntimeError(f"loop_cost_kernel launch failed: CUDA error {err}")
    LAUNCHES[config] += 1
    return out
