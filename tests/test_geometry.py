"""Geometry predicate tests (randomised, mirroring the reference's self-tests
in tri_ray_intersection.py:121-253 and tri_box_intersection.py:122-181, plus
analytic cases)."""

import numpy as np
import pytest

from pffdtd_jax.geometry import tris_precompute, tri_ray_intersect, tri_box_intersect
from pffdtd_jax.utils import normalise


def _scalar_ray_tri(ro, rd, tri, i, d_eps=1e-6, cp_eps=1e-6):
    """Straightforward scalar implementation for cross-checking."""
    un = rd / np.linalg.norm(rd)
    beta = un @ tri.unor[i]
    if abs(beta) < cp_eps:
        return False, np.inf
    t = tri.unor[i] @ (tri.cent[i] - ro) / beta
    if t < 0:
        return False, np.inf
    pop = ro + t * un
    v = tri.v[i]
    for (a, b), en in (((0, 1), tri.eab_unor[i]), ((1, 2), tri.ebc_unor[i]),
                       ((2, 0), tri.eca_unor[i])):
        if (pop - 0.5 * (v[a] + v[b])) @ en > d_eps:
            return False, np.inf
    return True, t


def test_tris_precompute_basic():
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], float)
    tp = tris_precompute(pts, np.array([[0, 1, 2]]))
    assert np.isclose(tp.area[0], 0.5)
    assert np.allclose(tp.unor[0], [0, 0, 1])
    assert np.allclose(tp.cent[0], [1 / 3, 1 / 3, 0])
    assert np.allclose(tp.bmin[0], [0, 0, 0])
    assert np.allclose(tp.bmax[0], [1, 1, 0])


def test_ray_tri_axis_aligned():
    pts = np.array([[0, 0, 1], [2, 0, 1], [0, 2, 1]], float)
    tp = tris_precompute(pts, np.array([[0, 1, 2]]))
    hit, t = tri_ray_intersect([0.5, 0.5, 0.0], [0, 0, 1], tp)
    assert hit[0, 0] and np.isclose(t[0, 0], 1.0)
    # pointing away
    hit, t = tri_ray_intersect([0.5, 0.5, 0.0], [0, 0, -1], tp)
    assert not hit[0, 0] and np.isinf(t[0, 0])
    # outside the triangle
    hit, _ = tri_ray_intersect([1.9, 1.9, 0.0], [0, 0, 1], tp)
    assert not hit[0, 0]


@pytest.mark.parametrize("seed", range(5))
def test_ray_tri_vec_matches_scalar(seed):
    rng = np.random.default_rng(seed)
    Ntris, Nrays = 7, 11
    pts = rng.standard_normal((Ntris * 3, 3))
    tp = tris_precompute(pts, np.arange(Ntris * 3).reshape(-1, 3))
    ro = normalise(rng.standard_normal((Nrays, 3))) * 3.0
    rd = normalise(rng.standard_normal((Nrays, 3)))

    hit, dist = tri_ray_intersect(ro, rd, tp)
    for r in range(Nrays):
        for t in range(Ntris):
            h, d = _scalar_ray_tri(ro[r], rd[r], tp, t)
            assert h == hit[r, t]
            assert d == dist[r, t] or np.isclose(d, dist[r, t])


def test_tri_box_axis_aligned():
    pts = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [0.5, 1.5, 0.5]], float)
    tp = tris_precompute(pts, np.array([[0, 1, 2]]))
    assert tri_box_intersect([0, 0, 0], [1, 1, 1], tp)[0]
    assert not tri_box_intersect([2, 2, 2], [3, 3, 3], tp)[0]
    # plane passes beside the box
    assert not tri_box_intersect([0, 0, 0.6], [0.4, 0.4, 1.0], tp)[0]


@pytest.mark.parametrize("seed", range(3))
def test_tri_box_consistency_with_sampling(seed):
    """A triangle intersecting a box must have a sampled point near/in it."""
    rng = np.random.default_rng(100 + seed)
    Ntris = 40
    pts = rng.standard_normal((Ntris * 3, 3))
    tp = tris_precompute(pts, np.arange(Ntris * 3).reshape(-1, 3))
    bmin, bmax = np.array([-0.5] * 3), np.array([0.5] * 3)
    hit = tri_box_intersect(bmin, bmax, tp)

    # dense barycentric sampling as a (sufficient-but-not-necessary) witness
    w = rng.dirichlet(np.ones(3), size=5000)
    for t in range(Ntris):
        samples = w @ tp.v[t]
        inside = np.all((samples >= bmin) & (samples <= bmax), -1).any()
        if inside:
            assert hit[t], "sampled point inside box but predicate says no hit"


def test_box_primitive(tmp_path):
    """Rotatable box (reference common/box.py): halfspace form agrees
    with the rotated vertices, AABB is tight, randomise stays valid,
    and the matplotlib debug draw renders."""
    from pffdtd_jax.geometry.box import Box

    rng = np.random.default_rng(7)
    for _ in range(20):
        b = Box().randomise(rng)
        # all 8 corners satisfy A x <= b (to fp tolerance)
        assert b.contains(b.verts, eps=1e-9).all()
        # interior point strictly inside, exterior point outside
        c = b.verts.mean(0)
        assert b.contains(c)[0]
        out = c + 2.0 * (b.bmax - b.bmin)
        assert not b.contains(out)[0]
        assert np.allclose(b.bmin, b.verts.min(0))
        assert np.allclose(b.bmax, b.verts.max(0))
        # volume is preserved by the rigid transform: check via the
        # triangulation's divergence-theorem volume
        v = b.verts
        t = v[b.tris]
        vol = abs(np.einsum("ij,ij->", np.cross(t[:, 1] - t[:, 0],
                                                t[:, 2] - t[:, 0]),
                            t[:, 0]) / 6.0)
        assert np.isclose(vol, np.prod(b.L), rtol=1e-9)
    f = tmp_path / "box.png"
    Box(2, 1, 1, Rang=30.0).draw(fname=f)
    assert f.exists()
