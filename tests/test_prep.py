"""Prep transforms: rotation, FCC folding and sorting must preserve physics.

Rotation/folding relabel indices (and permute adjacency columns), so outputs
agree with the untransformed run to machine accuracy (leg summation order
changes, hence not bitwise).
"""

import numpy as np
import pytest

from pffdtd_jax.demo import synthetic_box_sim
from pffdtd_jax.engine.numpy_ref import NumpyEngine
from pffdtd_jax.engine.jax_engine import JaxEngine
from pffdtd_jax.prep import fold_fcc_sim, rotate_sim, sort_sim


def _run(sim, engine="numpy"):
    if engine == "numpy":
        eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                          mats=sim.mats)
        u = eng.run_all()
        return u[sim.comms.out_reorder]
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float64)
    eng.run(verbose=False)
    return eng.u_out[sim.comms.out_reorder]


def test_rotate_preserves_outputs():
    sim = synthetic_box_sim(2.6, 2.0, 1.5, h=0.14, Nt=50, lossy=True,
                            insig_type="hann10", diff_source=False)
    base = _run(sim)
    rot = rotate_sim(sim, tr=(2, 0, 1))
    assert (rot.vox.Nx, rot.vox.Ny, rot.vox.Nz) != \
        (sim.vox.Nx, sim.vox.Ny, sim.vox.Nz)
    out = _run(rot)
    assert np.allclose(out, base, rtol=0, atol=1e-12 * np.abs(base).max())


def test_rotate_descending():
    sim = synthetic_box_sim(1.5, 2.6, 2.0, h=0.14, Nt=10, lossy=False)
    rot = rotate_sim(sim)
    assert rot.vox.Nx >= rot.vox.Ny >= rot.vox.Nz


@pytest.mark.parametrize("dims,want", [((1.5, 2.6, 2.0), (1, 2, 0)),
                                       ((2.6, 2.0, 1.5), None),
                                       ((2.0, 1.5, 2.6), (2, 0, 1))])
def test_rotate_auto_rule(dims, want):
    # the reference's rule: dims in descending order, longest on x (the
    # slab axis); an already-descending grid is returned unchanged
    sim = synthetic_box_sim(*dims, h=0.14, Nt=10, lossy=False)
    N = (sim.vox.Nx, sim.vox.Ny, sim.vox.Nz)
    rot = rotate_sim(sim)
    if want is None:
        assert rot is sim
    else:
        assert (rot.vox.Nx, rot.vox.Ny, rot.vox.Nz) == tuple(
            N[k] for k in want)


def test_rotate_auto_keeps_folded_y():
    # a folded FCC grid's half-y axis must stay on y; x and z still take
    # the longer and the shorter of the other two
    sim = synthetic_box_sim(1.7, 2.3, 3.1, h=0.09, Nt=10, fcc=True,
                            lossy=False)
    folded = fold_fcc_sim(sim)
    rot = rotate_sim(folded)
    assert rot.vox.Ny == folded.vox.Ny
    assert (rot.vox.Nx, rot.vox.Nz) == (folded.vox.Nz, folded.vox.Nx)
    assert rot.vox.Nx >= rot.vox.Nz


def test_sort_preserves_outputs():
    sim = synthetic_box_sim(2.6, 2.0, 1.5, h=0.14, Nt=50, lossy=True,
                            insig_type="hann10", diff_source=False)
    base = _run(sim)
    # scramble then sort back
    rng = np.random.default_rng(0)
    from dataclasses import replace

    p = rng.permutation(sim.vox.Nb)
    q = rng.permutation(sim.comms.out_ixyz.size)
    scr = replace(sim,
                  vox=replace(sim.vox, bn_ixyz=sim.vox.bn_ixyz[p],
                              adj_bn=sim.vox.adj_bn[p],
                              mat_bn=sim.vox.mat_bn[p],
                              saf_bn=sim.vox.saf_bn[p]),
                  comms=replace(sim.comms, out_ixyz=sim.comms.out_ixyz[q],
                                out_reorder=np.argsort(q)))
    srt = sort_sim(scr)
    assert np.all(np.diff(srt.vox.bn_ixyz) > 0)
    out = _run(srt)
    assert np.allclose(out, base, rtol=0, atol=1e-12 * np.abs(base).max())


def test_fcc_fold_preserves_outputs():
    sim = synthetic_box_sim(2.6, 2.0, 1.5, h=0.12, Nt=60, fcc=True,
                            lossy=True, insig_type="hann10",
                            diff_source=False)
    base = _run(sim)
    folded = fold_fcc_sim(sim)
    assert folded.consts.fcc_flag == 2
    assert folded.vox.Ny == sim.vox.Ny // 2 + 1
    out = _run(folded)
    assert np.allclose(out, base, rtol=0, atol=1e-10 * np.abs(base).max())
    # and through the JAX engine
    out_j = _run(folded, engine="jax")
    assert np.allclose(out_j, base, rtol=0, atol=1e-10 * np.abs(base).max())


def test_rotate_after_fold_preserves_outputs():
    # the MV routing fix re-rotates the FOLDED grid (x <-> z, the folded y
    # axis stays put) to move the long axis off the lane dimension: the
    # adjacency column permutation must compose correctly with the fold's
    # y-leg swaps
    sim = synthetic_box_sim(3.1, 2.3, 1.7, h=0.09, Nt=40, fcc=True,
                            lossy=True, insig_type="impulse")
    folded = sort_sim(fold_fcc_sim(rotate_sim(sim)))
    base = _run(folded)
    rot = sort_sim(rotate_sim(folded, tr=(2, 1, 0)))
    assert rot.consts.fcc_flag == 2
    assert (rot.vox.Nx, rot.vox.Ny, rot.vox.Nz) == \
        (folded.vox.Nz, folded.vox.Ny, folded.vox.Nx)
    out = _run(rot)
    assert np.allclose(out, base, rtol=0, atol=1e-12 * np.abs(base).max())
