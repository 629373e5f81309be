"""Unit-space quadric intersectors (port of ``bpt_tpu.geometry.quadrics``).

Each intersector takes object-space rays (..., 3) and returns ``(t, n)``:
the closest positive hit distance (INFINITY on a miss) and the
*unnormalized* object-space gradient normal; callers normalize and move it
to world space.  Every expression keeps the reference's operation order
(``x ** 2`` is written ``x * x``, as XLA computes it), so that the CUDA
kernel (``csrc/quadrics.cuh``), which mirrors these functions, computes the
same floats.  ``UNIT_INTERSECTORS`` lists the twelve shapes of the
transformed-quadric scene in the reference's order.
"""

from __future__ import annotations

import torch

from bpt_tpu_torch.core.vecmath import INFINITY, dot, safe_inv, safe_sqrt

#: Fixed trip count of the torus SDF march, and how often (in steps) its
#: plain version checks whether any lane still marches.
TORUS_MAX_STEPS = 500
TORUS_CHECK_EVERY = 32


def _up(ro):
    """(0, 1, 0) for every ray: the disk's and rectangle's normal, and the
    placeholder normal of a miss."""
    return torch.tensor([0.0, 1.0, 0.0], dtype=ro.dtype, device=ro.device).expand(ro.shape)


def _inf(t):
    return torch.full_like(t, INFINITY)


def _at(ro, rd, t):
    """ro + rd * t."""
    return ro + rd * t[..., None]


def _k(k, ro) -> torch.Tensor:
    return torch.as_tensor(k, dtype=ro.dtype).to(ro.device)


def solve_quadratic(a, b, c):
    """Stable quadratic roots; a negative discriminant gives t0 = t1 = 0
    (an automatic miss, since hits need t > 0), as in the reference."""
    inv_a = safe_inv(a)
    b = b * inv_a
    c = c * inv_a
    neg_half_b = -b * 0.5
    u2 = neg_half_b * neg_half_b - c
    real = u2 >= 0.0
    u = safe_sqrt(u2)
    zero = torch.zeros_like(u)
    neg_half_b = torch.where(real, neg_half_b, zero)
    u = torch.where(real, u, zero)
    return neg_half_b - u, neg_half_b + u


def _pick_two(t0, n0, ok0, t1, n1, ok1, ro):
    """t0 if valid, else t1 if valid, else INFINITY."""
    t = torch.where(ok0, t0, torch.where(ok1, t1, _inf(t0)))
    n = torch.where(ok0[..., None], n0, torch.where(ok1[..., None], n1, _up(ro)))
    return t, n


def _first_of(cands, ro):
    """The first valid (t, n, ok) candidate of a priority list."""
    t_out = _inf(cands[0][0])
    n_out = _up(ro)
    for tc, nc, ok in reversed(cands):
        t_out = torch.where(ok, tc, t_out)
        n_out = torch.where(ok[..., None], nc, n_out)
    return t_out, n_out


def _xz2(ro, rd):
    """(a, b, c) of the infinite unit cylinder x^2 + z^2 = 1."""
    a = rd[..., 0] * rd[..., 0] + rd[..., 2] * rd[..., 2]
    b = 2.0 * (rd[..., 0] * ro[..., 0] + rd[..., 2] * ro[..., 2])
    c = ro[..., 0] * ro[..., 0] + ro[..., 2] * ro[..., 2] - 1.0
    return a, b, c


def _cyl_normal(hit):
    return torch.stack([2.0 * hit[..., 0], torch.zeros_like(hit[..., 1]), 2.0 * hit[..., 2]], dim=-1)


def sphere_intersect(radius, pos, ro, rd):
    """World-space sphere of ``radius`` at ``pos``; t only."""
    ell = ro - pos
    a = dot(rd, rd)
    b = 2.0 * dot(rd, ell)
    c = dot(ell, ell) - radius * radius
    t0, t1 = solve_quadratic(a, b, c)
    return torch.where(t0 > 0.0, t0, torch.where(t1 > 0.0, t1, _inf(t1)))


def unit_sphere_intersect(ro, rd):
    """Unit sphere at the origin; n = 2 * hit."""
    a = dot(rd, rd)
    b = 2.0 * dot(rd, ro)
    c = dot(ro, ro) - 1.0
    t0, t1 = solve_quadratic(a, b, c)
    return _pick_two(t0, 2.0 * _at(ro, rd, t0), t0 > 0.0, t1, 2.0 * _at(ro, rd, t1), t1 > 0.0, ro)


def unit_cylinder_intersect(ro, rd):
    """x^2 + z^2 = 1, |y| <= 1."""
    t0, t1 = solve_quadratic(*_xz2(ro, rd))
    h0, h1 = _at(ro, rd, t0), _at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (torch.abs(h0[..., 1]) <= 1.0)
    ok1 = (t1 > 0.0) & (torch.abs(h1[..., 1]) <= 1.0)
    return _pick_two(t0, _cyl_normal(h0), ok0, t1, _cyl_normal(h1), ok1, ro)


def unit_cone_intersect(ro, rd, k):
    """Unit cone / frustum; k in [0.01, 1] sets the apex sharpness."""
    k = torch.clamp(_k(k, ro), 0.01, 1.0)
    j = 1.0 / k
    h = j * 2.0 - 1.0
    kq = k * 0.25
    rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
    rox, roy, roz = ro[..., 0], ro[..., 1], ro[..., 2]
    a = j * (rdx * rdx) + j * (rdz * rdz) - kq * (rdy * rdy)
    b = 2.0 * (j * rdx * rox + j * rdz * roz - kq * rdy * (roy - h))
    c = j * (rox * rox) + j * (roz * roz) - kq * ((roy - h) * (roy - h))
    t0, t1 = solve_quadratic(a, b, c)

    def nrm(hit):
        return torch.stack([2.0 * hit[..., 0] * j, 2.0 * (h - hit[..., 1]) * kq, 2.0 * hit[..., 2] * j], dim=-1)

    h0, h1 = _at(ro, rd, t0), _at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (torch.abs(h0[..., 1]) <= 1.0)
    ok1 = (t1 > 0.0) & (torch.abs(h1[..., 1]) <= 1.0)
    return _pick_two(t0, nrm(h0), ok0, t1, nrm(h1), ok1, ro)


def unit_paraboloid_intersect(ro, rd):
    """Unit paraboloid, fixed k = 0.5."""
    k = 0.5
    a = rd[..., 0] * rd[..., 0] + rd[..., 2] * rd[..., 2]
    b = 2.0 * (rd[..., 0] * ro[..., 0] + rd[..., 2] * ro[..., 2]) + k * rd[..., 1]
    c = ro[..., 0] * ro[..., 0] + ro[..., 2] * ro[..., 2] + k * (ro[..., 1] - 1.0)
    t0, t1 = solve_quadratic(a, b, c)

    def nrm(hit):
        return torch.stack([2.0 * hit[..., 0], torch.full_like(hit[..., 1], 0.5), 2.0 * hit[..., 2]], dim=-1)

    h0, h1 = _at(ro, rd, t0), _at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (torch.abs(h0[..., 1]) <= 1.0)
    ok1 = (t1 > 0.0) & (torch.abs(h1[..., 1]) <= 1.0)
    return _pick_two(t0, nrm(h0), ok0, t1, nrm(h1), ok1, ro)


def unit_hyperboloid_intersect(ro, rd, k):
    """Unit hyperboloid; k remapped to (k^4 + 0.0012) * 1000."""
    k = _k(k, ro)
    k = (k * k * k * k + 0.0012) * 1000.0
    j = k - 1.0
    rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
    rox, roy, roz = ro[..., 0], ro[..., 1], ro[..., 2]
    a = k * (rdx * rdx) + k * (rdz * rdz) - j * (rdy * rdy)
    b = 2.0 * (k * rdx * rox + k * rdz * roz - j * rdy * roy)
    c = (k * (rox * rox) + k * (roz * roz) - j * (roy * roy)) - 1.0
    t0, t1 = solve_quadratic(a, b, c)

    def nrm(hit):
        return torch.stack([2.0 * hit[..., 0] * k, -2.0 * hit[..., 1] * j, 2.0 * hit[..., 2] * k], dim=-1)

    h0, h1 = _at(ro, rd, t0), _at(ro, rd, t1)
    ok0 = (t0 > 0.0) & (torch.abs(h0[..., 1]) <= 1.0)
    ok1 = (t1 > 0.0) & (torch.abs(h1[..., 1]) <= 1.0)
    return _pick_two(t0, nrm(h0), ok0, t1, nrm(h1), ok1, ro)


def unit_capsule_intersect(ro, rd, k):
    """Two unit-radius sphere caps at y = +-(k + 0.25) and the cylinder
    between them; all first roots are tested before all second roots."""
    k = _k(k, ro) + 0.25

    def cap(center_y):
        ell = torch.stack([ro[..., 0], ro[..., 1] - center_y, ro[..., 2]], dim=-1)
        return solve_quadratic(dot(rd, rd), 2.0 * dot(rd, ell), dot(ell, ell) - 1.0)

    s0t0, s0t1 = cap(k)
    s1t0, s1t1 = cap(-k)
    t0, t1 = solve_quadratic(*_xz2(ro, rd))

    def cap_n(t, off):
        hit = _at(ro, rd, t)
        return torch.stack([2.0 * hit[..., 0], 2.0 * (hit[..., 1] - off), 2.0 * hit[..., 2]], dim=-1)

    def y(t):
        return _at(ro, rd, t)[..., 1]

    cands = [
        (s0t0, cap_n(s0t0, k), (s0t0 > 0.0) & (y(s0t0) >= k)),
        (s1t0, cap_n(s1t0, -k), (s1t0 > 0.0) & (y(s1t0) <= -k)),
        (t0, _cyl_normal(_at(ro, rd, t0)), (t0 > 0.0) & (torch.abs(y(t0)) <= k)),
        (s0t1, cap_n(s0t1, k), (s0t1 > 0.0) & (y(s0t1) >= k)),
        (s1t1, cap_n(s1t1, -k), (s1t1 > 0.0) & (y(s1t1) <= -k)),
        (t1, _cyl_normal(_at(ro, rd, t1)), (t1 > 0.0) & (torch.abs(y(t1)) <= k)),
    ]
    return _first_of(cands, ro)


def unit_flattened_ring_intersect(ro, rd, k):
    """CSG ring: outer cylinder, annular disks, inner cylinder, rear faces;
    k - 0.01 is the squared hole radius."""
    k = _k(k, ro) - 0.01
    a, b, c_outer = _xz2(ro, rd)
    t0, t1 = solve_quadratic(a, b, c_outer)
    c0, c1 = solve_quadratic(a, b, c_outer + 1.0 - k)
    inv_y = safe_inv(rd[..., 1])
    d0 = -(ro[..., 1] - 1.0) * inv_y
    d1 = -(ro[..., 1] + 1.0) * inv_y

    def disk_ok(d):
        hit = _at(ro, rd, d)
        x2z2 = hit[..., 0] * hit[..., 0] + hit[..., 2] * hit[..., 2]
        return (d > 0.0) & (x2z2 <= 1.0) & (x2z2 > k)

    def side_ok(t):
        return (t > 0.0) & (torch.abs(_at(ro, rd, t)[..., 1]) <= 1.0)

    up = _up(ro)
    down = -up
    cands = [
        (t0, _cyl_normal(_at(ro, rd, t0)), side_ok(t0)),
        (d0, up, (rd[..., 1] < 0.0) & disk_ok(d0)),
        (d1, down, (rd[..., 1] > 0.0) & disk_ok(d1)),
        (c0, _cyl_normal(_at(ro, rd, c0)), side_ok(c0)),
        (c1, _cyl_normal(_at(ro, rd, c1)), side_ok(c1)),
        (t1, _cyl_normal(_at(ro, rd, t1)), side_ok(t1)),
        (d0, up, (rd[..., 1] > 0.0) & disk_ok(d0)),
        (d1, down, (rd[..., 1] < 0.0) & disk_ok(d1)),
    ]
    return _first_of(cands, ro)


def unit_box_intersect(ro, rd):
    """Slab test on [-1, 1]^3 with the step-trick face normal."""
    inv = safe_inv(rd)
    near = (-1.0 - ro) * inv
    far = (1.0 - ro) * inv
    tmin = torch.minimum(near, far)
    tmax = torch.maximum(near, far)
    t0 = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    t1 = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    neg_sign = -torch.sign(rd)

    def rolled(v, shift):
        return torch.roll(v, -shift, dims=-1)

    f32 = ro.dtype
    n_enter = neg_sign * (tmin >= rolled(tmin, 1)).to(f32) * (tmin >= rolled(tmin, 2)).to(f32)
    n_exit = neg_sign * (tmax <= rolled(tmax, 1)).to(f32) * (tmax <= rolled(tmax, 2)).to(f32)
    ok = t0 < t1
    return _pick_two(t0, n_enter, ok & (t0 > 0.0), t1, n_exit, ok & (t1 > 0.0), ro)


def pyramid_frustum_intersect(ro, rd, k):
    """Pyramid / frustum: two cone-like quadratics (x and z sides) clipped to
    the box; the nearer side wins, x on a tie."""
    k = torch.clamp(_k(k, ro), 0.01, 1.0)
    j = 1.0 / k
    h = j * 2.0 - 1.0
    kq = k * 0.25

    def side(main, other):
        a = j * (rd[..., main] * rd[..., main]) - kq * (rd[..., 1] * rd[..., 1])
        b = 2.0 * (j * rd[..., main] * ro[..., main] - kq * rd[..., 1] * (ro[..., 1] - h))
        c = j * (ro[..., main] * ro[..., main]) - kq * ((ro[..., 1] - h) * (ro[..., 1] - h))
        t0, t1 = solve_quadratic(a, b, c)

        def valid(t):
            hit = _at(ro, rd, t)
            inside_other = (j * (hit[..., other] * hit[..., other])
                            - kq * ((hit[..., 1] - h) * (hit[..., 1] - h))) <= 0.0
            return ((t > 0.0) & (torch.abs(hit[..., 0]) <= 1.0) & (torch.abs(hit[..., 2]) <= 1.0)
                    & (hit[..., 1] <= 1.0) & inside_other)

        def nrm(t):
            hit = _at(ro, rd, t)
            comp_main = 2.0 * hit[..., main] * j
            comp_y = 2.0 * (hit[..., 1] - h) * -kq
            zeros = torch.zeros_like(comp_y)
            if main == 0:
                return torch.stack([comp_main, comp_y, zeros], dim=-1)
            return torch.stack([zeros, comp_y, comp_main], dim=-1)

        ok0 = valid(t0)
        ok1 = valid(t1) & ~ok0
        return _pick_two(t0, nrm(t0), ok0, t1, nrm(t1), ok1, ro)

    xt, xn = side(0, 2)
    zt, zn = side(2, 0)
    use_x = xt <= zt
    return torch.where(use_x, xt, zt), torch.where(use_x[..., None], xn, zn)


def unit_disk_intersect(ro, rd):
    """y = 0 disk of radius 1; t only (the caller supplies the normal)."""
    t0 = -ro[..., 1] * safe_inv(rd[..., 1])
    hit = _at(ro, rd, t0)
    ok = (t0 > 0.0) & (hit[..., 0] * hit[..., 0] + hit[..., 2] * hit[..., 2] <= 1.0)
    return torch.where(ok, t0, _inf(t0))


def unit_rectangle_intersect(ro, rd):
    """y = 0 rectangle, |x|, |z| <= 1; t only."""
    t0 = -ro[..., 1] * safe_inv(rd[..., 1])
    hit = _at(ro, rd, t0)
    ok = (t0 > 0.0) & (torch.abs(hit[..., 0]) <= 1.0) & (torch.abs(hit[..., 2]) <= 1.0)
    return torch.where(ok, t0, _inf(t0))


def _map_torus(pos, k):
    """SDF: length(vec2(length(pos.xz) - (1 - k), pos.y)) - k."""
    ring = torch.sqrt(torch.clamp(pos[..., 0] * pos[..., 0] + pos[..., 2] * pos[..., 2], min=1e-20)) - (1.0 - k)
    return torch.sqrt(torch.clamp(ring * ring + pos[..., 1] * pos[..., 1], min=1e-20)) - k


def unit_torus_intersect(ro, rd, k, check_every: int | None = TORUS_CHECK_EVERY, steps_out: list | None = None):
    """Analytic bound + SDF march from the nearest of {bounding cylinder
    side, two cap disks}.

    The march is the reference's fixed 500-step loop in which a lane
    freezes for good once ``|d| < 0.01`` or ``t - t_start > 8``.  Since a
    frozen lane never changes again, the loop stops as soon as no lane
    marches; it looks every ``check_every`` steps (``check_every=None``:
    never, the full fixed loop), so a card syncs ~16 times, not 500.  The
    result is the same either way, bit for bit.  ``steps_out``, for
    measurement, receives the per-lane number of SDF evaluations of lanes
    that start inside the bound (the others miss without marching in the
    CUDA kernel).
    """
    k = 1.0 - torch.clamp(_k(k, ro), 0.01, 0.99)
    t0, t1 = solve_quadratic(*_xz2(ro, rd))
    h0y = _at(ro, rd, t0)[..., 1]
    h1y = _at(ro, rd, t1)[..., 1]
    inf = _inf(t0)
    tc = torch.where((t0 > 0.0) & (torch.abs(h0y) <= k), t0,
                     torch.where((t1 > 0.0) & (torch.abs(h1y) <= k), t1, inf))
    inv_y = safe_inv(rd[..., 1])

    def disk(off):
        d = -(ro[..., 1] + off) * inv_y
        hit = _at(ro, rd, d)
        ok = (d > 0.0) & (hit[..., 0] * hit[..., 0] + hit[..., 2] * hit[..., 2] <= 1.0)
        return torch.where(ok, d, inf)

    t_start = torch.minimum(torch.minimum(disk(k), disk(-k)), tc)
    bounded = t_start < INFINITY
    t_march0 = torch.where(bounded, t_start, torch.zeros_like(t_start))  # unbounded lanes march from 0

    t, d = t_march0, inf
    steps = torch.zeros(t.shape, dtype=torch.int32, device=t.device) if steps_out is not None else None
    for step in range(TORUS_MAX_STEPS):
        live = (torch.abs(d) >= 0.01) & (t - t_march0 <= 8.0)
        if check_every and step % check_every == 0 and not bool(live.any()):
            break
        d_new = _map_torus(_at(ro, rd, t), k)
        t = torch.where(live & (torch.abs(d_new) >= 0.01), t + d_new, t)
        d = torch.where(live, d_new, d)
        if steps is not None:
            steps = steps + (live & bounded).to(torch.int32)
    if steps_out is not None:
        steps_out.append(steps)
    converged = bounded & (torch.abs(d) < 0.01)
    pos = _at(ro, rd, t)
    e = 0.5773 * 0.0002
    taps = [torch.tensor(v, dtype=ro.dtype, device=ro.device)
            for v in ((e, -e, -e), (-e, -e, e), (-e, e, -e), (e, e, e))]
    n = sum((tap * _map_torus(pos + tap, k)[..., None] for tap in taps[1:]),
            taps[0] * _map_torus(pos + taps[0], k)[..., None])
    return torch.where(converged, t, inf), torch.where(converged[..., None], n, _up(ro))


def _disk_with_normal(ro, rd):
    return unit_disk_intersect(ro, rd), _up(ro)


def _rect_with_normal(ro, rd):
    return unit_rectangle_intersect(ro, rd), _up(ro)


# Shape ids of the transformed-quadric scene, in the reference's
# SceneIntersect order: the CUDA kernel's quadric index i is entry i.
UNIT_INTERSECTORS = (
    ("sphere", lambda ro, rd, k: unit_sphere_intersect(ro, rd)),
    ("cylinder", lambda ro, rd, k: unit_cylinder_intersect(ro, rd)),
    ("cone", unit_cone_intersect),
    ("paraboloid", lambda ro, rd, k: unit_paraboloid_intersect(ro, rd)),
    ("hyperboloid", unit_hyperboloid_intersect),
    ("capsule", unit_capsule_intersect),
    ("flattened_ring", unit_flattened_ring_intersect),
    ("box", lambda ro, rd, k: unit_box_intersect(ro, rd)),
    ("pyramid_frustum", pyramid_frustum_intersect),
    ("disk", lambda ro, rd, k: _disk_with_normal(ro, rd)),
    ("rectangle", lambda ro, rd, k: _rect_with_normal(ro, rd)),
    ("torus", unit_torus_intersect),
)
