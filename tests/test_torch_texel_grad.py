"""The texel VJP: which route ``texel_grad.sample_learnt`` (the fused
route's sampler) takes for its map's gradient, and (on a CUDA card only)
the kernel against the plain route.

The card tests carry the ``cuda`` marker and skip without a GPU; run them
on the card with ``python -m pytest tests/test_torch_texel_grad.py --noconftest -m cuda``
(this file imports no jax).

Tolerance of the kernel against the plain route: both add the same float32
terms (g (1 - fy)) (1 - fx) ... into each texel, in other orders (the plain
route's ``index_add_`` in its atomics' order, tap by tap).  A sum of n terms
in any order lies within (n - 1) u sum|terms| of the exact sum (u = 2^-24,
Higham), so two orders differ by at most n eps sum|terms| (eps = 2^-23),
with n the texel's terms and sum|terms| the plain route's gradient of |g|.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bpt_tpu_torch import textures
from bpt_tpu_torch.kernels import texel_grad
from bpt_tpu_torch.kernels.texel_grad import TEXEL_GRAD_LAUNCHES, shared_bytes

torch.set_num_threads(2)

H100_SMEM = 232448  # an H100's opt-in shared memory of a block, bytes


@dataclasses.dataclass
class CardTensor:
    """What ``texel_grad.texel_kernel_route`` reads of a tensor, for a CUDA tensor on a
    machine without one."""
    requires_grad: bool
    shape: tuple
    dtype: torch.dtype = torch.float32
    is_cuda: bool = True


def _uv_map(shape, n, lo=0.0, hi=1.0, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    tex = torch.rand(shape, generator=gen)
    uv = torch.rand(n, 2, generator=gen) * (hi - lo) + lo
    return tex.to(device), uv.to(device)


# ---- the route (CPU) ----------------------------------------------------------------


@pytest.mark.parametrize("tex,uv,grad_mode,expected", [
    (CardTensor(True, (64, 64, 3)), CardTensor(False, (8, 2)), "enabled", True),
    (CardTensor(True, (64, 64, 3)), CardTensor(False, (8, 2)), "no_grad", False),
    (CardTensor(True, (64, 64, 3)), CardTensor(False, (8, 2)), "inference_mode", False),
    (CardTensor(True, (64, 64, 3)), CardTensor(True, (8, 2)), "enabled", False),
    (CardTensor(False, (64, 64, 3)), CardTensor(False, (8, 2)), "enabled", False),
    (CardTensor(True, (64, 64, 5)), CardTensor(False, (8, 2)), "enabled", False),
    (CardTensor(True, (64, 64, 3), torch.float64), CardTensor(False, (8, 2), torch.float64), "enabled", False),
    (CardTensor(True, (64, 64, 3), is_cuda=False), CardTensor(False, (8, 2), is_cuda=False), "enabled", False),
    (CardTensor(True, (2048, 2048, 3)), CardTensor(False, (8, 2)), "enabled", False),
], ids=["kernel", "no_grad", "inference_mode", "uv_grad", "map_fixed", "five_channels", "float64", "cpu",
        "over_the_limit"])
def test_texel_kernel_route(tex, uv, grad_mode, expected):
    """The kernel takes a learnt float32 CUDA map's gradient where the UVs
    need none and the map's block fits the card's shared memory, while
    autograd records; every other case takes autograd's plain route."""
    modes = {"enabled": torch.enable_grad, "no_grad": torch.no_grad, "inference_mode": torch.inference_mode}
    with modes[grad_mode]():
        assert texel_grad.texel_kernel_route(tex, uv, H100_SMEM) is expected


@pytest.mark.parametrize("uv_grad", [False, True])
def test_cpu_tensors_take_the_plain_route(uv_grad):
    """On CPU tensors ``sample_learnt`` is the plain sample, its map's and
    UVs' gradients autograd's (the map's ``texel_grad_reference``'s), and no
    kernel launches; ``texel_grad`` refuses CPU tensors."""
    tex, uv = _uv_map((5, 7, 3), 300, -2.0, 3.0)
    tex.requires_grad_(True)
    uv.requires_grad_(uv_grad)
    before = dict(TEXEL_GRAD_LAUNCHES)
    out = texel_grad.sample_learnt(tex, uv)
    assert type(out.grad_fn).__name__ != "_TexelVJPBackward"
    torch.testing.assert_close(out, textures.sample_bilinear(tex, uv), rtol=0, atol=0)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    grads = torch.autograd.grad(out, [tex, uv] if uv_grad else [tex], g)
    torch.testing.assert_close(grads[0], texel_grad.texel_grad_reference(uv, g, tex.shape), rtol=0, atol=0)
    if uv_grad:
        assert grads[1].abs().sum() > 0
    assert TEXEL_GRAD_LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        texel_grad.texel_grad(uv.detach(), g, tex.shape)


@pytest.mark.parametrize("shape,limit,expected", [
    ((64, 64, 3), H100_SMEM, True),
    ((2048, 2048, 3), H100_SMEM, False),
    ((1, 1, 1), H100_SMEM, True),
    ((64, 64, 3), shared_bytes(64, 64, 3), True),
    ((64, 64, 3), shared_bytes(64, 64, 3) - 1, False),
])
def test_kernel_route_follows_the_maps_bytes(shape, limit, expected):
    """The kernel wherever a block's copy of the map's gradient and its
    staged cotangents fit the limit, the plain route above it."""
    assert shared_bytes(*shape) == 4 * (shape[0] * shape[1] * shape[2] + 32 * shape[2])
    assert texel_grad.texel_kernel_route(CardTensor(True, shape), CardTensor(False, (8, 2)), limit) is expected


def test_texel_grad_rejects_bad_shapes():
    uv, g = torch.zeros(4, 2), torch.zeros(4, 3)
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        texel_grad.texel_grad(uv, g[:, :2], (8, 8, 3))
    with pytest.raises(ValueError, match="on"):
        texel_grad.texel_grad(uv, g.to("meta"), (8, 8, 3))


# ---- the kernel against the plain route (card) --------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _order_bound(uv, g, shape):
    """n eps sum|terms| per texel (the module's docstring)."""
    h, w, _ = shape
    x0i, x1i, y0i, y1i, _, _ = textures._coords(h, w, uv)
    live = (g != 0).any(-1).reshape(-1)
    count = torch.zeros(h * w, device=g.device)
    for y in (y0i, y1i):
        for x in (x0i, x1i):
            idx = (y * w + x).reshape(-1)[live]
            count.index_add_(0, idx, torch.ones_like(idx, dtype=count.dtype))
    return count.reshape(h, w, 1) * torch.finfo(torch.float32).eps * texel_grad.texel_grad_reference(uv, g.abs(),
                                                                                                      shape)


CASES = {  # shape, lanes, UV range, share of lanes that apply no sample
    "64x64_1024sq_unapplied": ((64, 64, 3), (1024, 1024), (0.0, 1.0), 0.6),
    "wrapped_uv": ((64, 64, 3), (256, 256), (-2.0, 3.0), 0.0),
    "one_texel": ((1, 1, 3), (128, 128), (-2.0, 3.0), 0.2),
    "one_row": ((1, 33, 3), (128, 128), (-2.0, 3.0), 0.2),
    "non_square_4ch": ((24, 40, 4), (256, 256), (-2.0, 3.0), 0.2),
    "one_channel": ((7, 5, 1), (256, 256), (0.0, 1.0), 0.2),
    "zero_cotangents": ((64, 64, 3), (512, 512), (0.0, 1.0), 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_the_plain_route(cuda_device, case):
    """``sample_learnt`` on a learnt map: the plain forward bit for bit, and
    the kernel's map gradient within the order bound of the plain route's
    (``textures.sample_bilinear``, four ``index_add_``).  Lanes that apply
    no sample get uv 0 and a 0 cotangent, as ``compose_deferred`` passes
    them."""
    shape, lanes, (lo, hi), unapplied = CASES[case]
    tex, uv = _uv_map(shape, lanes[0] * lanes[1], lo, hi, device=cuda_device)
    uv = uv.reshape(*lanes, 2)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    applied = torch.rand(lanes, generator=gen, device=cuda_device) >= unapplied
    uv = torch.where(applied[..., None], uv, 0.0)
    g = torch.where(applied[..., None], torch.randn(*lanes, shape[2], generator=gen, device=cuda_device), 0.0)
    leaf = tex.clone().requires_grad_(True)
    before = dict(TEXEL_GRAD_LAUNCHES)
    out = texel_grad.sample_learnt(leaf, uv)
    assert type(out.grad_fn).__name__ == "_TexelVJPBackward"
    (got,) = torch.autograd.grad(out, [leaf], g)
    torch.cuda.synchronize()
    assert TEXEL_GRAD_LAUNCHES["shared"] == before["shared"] + 1
    plain_leaf = tex.clone().requires_grad_(True)
    plain = textures.sample_bilinear(plain_leaf, uv)
    (want,) = torch.autograd.grad(plain, [plain_leaf], g)
    assert torch.equal(out, plain)
    err, bound = (got - want).abs(), _order_bound(uv, g, shape)
    assert bool((err <= bound).all()), f"{float((err - bound).max())} over the bound"
    if unapplied == 1.0:
        assert not bool(got.any())
    else:
        assert bool(got.any())


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    """Two launches on the same inputs give the same bits."""
    tex, uv = _uv_map((64, 64, 3), 1024 * 1024, device=cuda_device)
    g = torch.randn(1024 * 1024, 3, generator=torch.Generator(device=cuda_device).manual_seed(5), device=cuda_device)
    first = texel_grad.texel_grad(uv, g, tex.shape)
    assert torch.equal(first, texel_grad.texel_grad(uv, g, tex.shape))


@pytest.mark.cuda
def test_uvs_that_need_a_gradient_take_the_plain_route(cuda_device):
    """With UVs that require a gradient no kernel launches, and both
    gradients are the plain route's: the UVs' bit for bit (elementwise),
    the map's within the order bound."""
    tex, uv = _uv_map((64, 64, 3), 256 * 256, -2.0, 3.0, device=cuda_device)
    g = torch.randn(256 * 256, 3, generator=torch.Generator(device=cuda_device).manual_seed(7), device=cuda_device)
    grads = []
    for fn in (texel_grad.sample_learnt, textures.sample_bilinear):
        leaves = [tex.clone().requires_grad_(True), uv.clone().requires_grad_(True)]
        before = dict(TEXEL_GRAD_LAUNCHES)
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
        assert TEXEL_GRAD_LAUNCHES == before
    assert torch.equal(grads[0][1], grads[1][1])
    assert bool(((grads[0][0] - grads[1][0]).abs() <= _order_bound(uv, g, tex.shape)).all())


@pytest.mark.cuda
def test_a_map_over_the_limit_takes_the_plain_route(cuda_device):
    """A learnt 2048² RGB map, whose gradient does not fit a block's shared
    memory, launches no kernel: its gradient is autograd's, within the order
    bound of another run of the plain route (both sum by atomics)."""
    tex, uv = _uv_map((2048, 2048, 3), 1024 * 1024, device=cuda_device)
    g = torch.randn(1024 * 1024, 3, generator=torch.Generator(device=cuda_device).manual_seed(9), device=cuda_device)
    assert shared_bytes(*tex.shape) > texel_grad.smem_limit(cuda_device)
    leaf = tex.clone().requires_grad_(True)
    before = dict(TEXEL_GRAD_LAUNCHES)
    out = texel_grad.sample_learnt(leaf, uv)
    assert type(out.grad_fn).__name__ != "_TexelVJPBackward"
    (got,) = torch.autograd.grad(out, [leaf], g)
    assert TEXEL_GRAD_LAUNCHES == before
    assert bool(((got - texel_grad.texel_grad_reference(uv, g, tex.shape)).abs()
                 <= _order_bound(uv, g, tex.shape)).all())


@pytest.mark.cuda
def test_fused_textured_step_launches_the_kernel_per_bounce(cuda_device, monkeypatch):
    """A fused textured render's backward into a learnt albedo launches the
    kernel once per bounce (``compose_deferred`` samples the albedo at
    each), and its gradient is the plain route's within the fused-vs-plain
    bar of tests/test_torch_mesh_grads.py (rtol 1e-4)."""
    from bpt_tpu_torch.core.rng import blue_noise_table
    from bpt_tpu_torch.integrator import IntegratorConfig
    from bpt_tpu_torch.kernels import megakernel
    from bpt_tpu_torch.scenes.gltf_scene import gltf_camera, gltf_scene, mesh_from_model
    from chip_smoke import blob_model

    rng = np.random.default_rng(7)  # tests/test_torch_kernels.py's textured blob: UVs that wrap, a 32x32 albedo
    uv = rng.uniform(-1.5, 2.5, (128, 3, 2)).astype(np.float32)
    model = blob_model(128)._replace(uv0=uv[:, 0], uv1=uv[:, 1], uv2=uv[:, 2],
                                     albedo=rng.uniform(0.1, 1.0, (32, 32, 3)).astype(np.float32))
    cfg = IntegratorConfig(bounces=4)
    scene = gltf_scene(mesh_from_model(model, mat_type=1, rotation=(0.3, 0.5, 0.0), scale=(1.5, 1.5, 1.5),
                                       translation=(0.0, -20.0, -85.0)), device=cuda_device)
    cam, bn = gltf_camera(device=cuda_device), torch.as_tensor(blue_noise_table()).to(cuda_device)
    weights = torch.randn(128, 128, 3, generator=torch.Generator(device=cuda_device).manual_seed(2),
                          device=cuda_device)

    def albedo_grad():
        albedo = scene.mesh.albedo.clone().requires_grad_(True)
        s = scene._replace(mesh=scene.mesh._replace(albedo=albedo))
        color = megakernel.trace_image_fused(s, cam, cfg, 128, 128, 2.0, np.array([0.3, 0.7], np.float32), bn,
                                             differentiable=True).color
        return torch.autograd.grad((weights * color).mean(), [albedo])[0]

    megakernel.reset_launches()
    got = albedo_grad()
    assert TEXEL_GRAD_LAUNCHES == {"shared": cfg.bounces}
    monkeypatch.setattr(texel_grad, "texel_kernel_route", lambda tex, uv, limit: False)
    want = albedo_grad()
    assert TEXEL_GRAD_LAUNCHES == {"shared": cfg.bounces}
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6 * scale)
