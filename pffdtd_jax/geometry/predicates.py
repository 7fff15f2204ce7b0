"""Vectorised geometry predicates: triangle-ray and triangle-box intersection.

Semantics parity targets:
- tri-ray: reference python/common/tri_ray_intersection.py:79-119
  (coplanarity test, positive plane distance, three signed edge-function tests
  with a distance slack d_eps).
- tri-box: reference python/common/tri_box_intersection.py:81-120
  (Schwarz-Seidel 2010: bbox overlap, plane-through-box, 9 2-D edge overlaps).

Unlike the reference (one-ray-many-tris OR one-tri-many-rays), these are fully
batched over both rays and triangles: shapes broadcast to (R, T).
"""

from __future__ import annotations

import numpy as np

from pffdtd_jax.geometry.tris import TriPre
from pffdtd_jax.utils import normalise

_F64EPS = np.finfo(np.float64).eps


def tri_ray_intersect(ray_o, ray_d, tri: TriPre, d_eps=1e-6, cp_eps=1e-6):
    """Batched ray-triangle intersection.

    ray_o, ray_d: (R, 3) (or (3,)).  tri: TriPre with T triangles.
    Returns (hit, t): both (R, T); t is +inf where there is no hit.
    A hit requires: ray not coplanar with the triangle plane (|cos| >= cp_eps),
    non-negative distance along the (normalised) ray, and the point-on-plane
    inside all three edge half-planes with slack d_eps.
    """
    ray_o = np.atleast_2d(np.asarray(ray_o, np.float64))  # (R, 3)
    ray_d = np.atleast_2d(np.asarray(ray_d, np.float64))
    ray_o, ray_d = np.broadcast_arrays(ray_o, ray_d)
    un = normalise(ray_d)
    d_eps, cp_eps = abs(d_eps), abs(cp_eps)

    # (R, T) cosine between ray and plane normal
    beta = un @ tri.unor.T
    fail = np.abs(beta) < cp_eps
    beta_safe = np.where(fail, -_F64EPS, beta)

    # distance to plane along the ray: dot(unor, cent - o) / beta, (R, T)
    num = tri.unor[None, :, :] * (tri.cent[None, :, :] - ray_o[:, None, :])
    t = num.sum(-1) / beta_safe
    fail |= t < 0

    # point on plane (R, T, 3)
    pop = ray_o[:, None, :] + un[:, None, :] * t[..., None]

    v = tri.v  # (T, 3, 3)
    mid_ab = 0.5 * (v[:, 0] + v[:, 1])
    mid_bc = 0.5 * (v[:, 1] + v[:, 2])
    mid_ca = 0.5 * (v[:, 2] + v[:, 0])
    fail |= np.sum((pop - mid_ab) * tri.eab_unor, -1) > d_eps
    fail |= np.sum((pop - mid_bc) * tri.ebc_unor, -1) > d_eps
    fail |= np.sum((pop - mid_ca) * tri.eca_unor, -1) > d_eps

    t_ret = np.where(fail, np.inf, t)
    return ~fail, t_ret


def tri_box_intersect(bbmin, bbmax, tri: TriPre):
    """Batched triangle vs one axis-aligned box (Schwarz-Seidel). Returns (T,) bool."""
    bbmin = np.asarray(bbmin, np.float64)
    bbmax = np.asarray(bbmax, np.float64)
    p = bbmin
    dp = bbmax - bbmin
    assert np.all(dp > 0)

    nor, v = tri.nor, tri.v

    # 1) bbox overlap
    fail = np.any((tri.bmin > bbmax) | (bbmin > tri.bmax), axis=-1)

    # 2) plane through box: critical corner test
    c = np.where(nor > 0, dp, 0.0)
    d1 = np.sum(nor * (c - tri.cent), -1)
    d2 = np.sum(nor * ((dp - c) - tri.cent), -1)
    np_dot = nor @ p
    fail |= (np_dot + d1) * (np_dot + d2) > 0

    # 3) nine 2-D edge-overlap tests (three projections x three edges)
    for q in range(3):
        xq, yq, zq = q, (q + 1) % 3, (q + 2) % 3
        for i in range(3):
            e = v[:, (i + 1) % 3, :] - v[:, i, :]
            vixy = 0.5 * (v[:, (i + 1) % 3][:, [xq, yq]] + v[:, i][:, [xq, yq]])
            ne = np.stack([-e[:, yq], e[:, xq]], axis=-1)
            ne = np.where(nor[:, zq:zq + 1] < 0, -ne, ne)
            dpx = dp[xq] * ne[:, 0]
            dpy = dp[yq] * ne[:, 1]
            de = -np.sum(ne * vixy, -1) + np.maximum(dpx, 0.0) + np.maximum(dpy, 0.0)
            fail |= (ne @ p[[xq, yq]] + de) < 0

    return ~fail
