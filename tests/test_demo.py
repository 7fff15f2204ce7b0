"""The analytic synthetic-box builder must agree with the real voxelizer."""

import numpy as np
import pytest

from pffdtd_jax.demo import make_shoebox_room, synthetic_box_sim
from pffdtd_jax.engine.numpy_ref import NumpyEngine
from pffdtd_jax.voxelizer import CartGrid, VoxScene


@pytest.mark.parametrize("fcc", [False, True])
def test_synthetic_matches_voxelizer(fcc):
    L = (2.0, 3.0, 2.5)
    h = 0.25
    sim = synthetic_box_sim(*L, h=h, Nt=4, fcc=fcc, lossy=False)

    rg = make_shoebox_room(*L)
    cg = CartGrid(h=h, offset=3.5, bmin=rg.bmin, bmax=rg.bmax, fcc=fcc)
    vs = VoxScene(rg, cg, fcc=fcc)
    vs.calc_adj(block_size=16, backend="numpy")

    assert np.array_equal(sim.vox.bn_ixyz, vs.bn_ixyz)
    # in-room nodes must agree exactly; exterior shell nodes may differ on
    # FCC diagonal legs that graze the box corner lines exactly (the ray
    # caster's d_eps slack counts those as hits) — they are never excited
    from pffdtd_jax.utils import ind2sub3d

    ix, iy, iz = ind2sub3d(vs.bn_ixyz, cg.Nx, cg.Ny, cg.Nz)
    x, y, z = cg.xv[ix], cg.yv[iy], cg.zv[iz]
    inside = ((x > 0) & (x < L[0]) & (y > 0) & (y < L[1])
              & (z > 0) & (z < L[2]))
    assert np.array_equal(sim.vox.adj_bn[inside], vs.adj_bn[inside])
    if not fcc:
        assert np.array_equal(sim.vox.adj_bn, vs.adj_bn)
    # synthetic adjacency is symmetric (stability precondition)
    vs2 = VoxScene(rg, cg, fcc=fcc)
    vs2.bn_ixyz, vs2.adj_bn = sim.vox.bn_ixyz, sim.vox.adj_bn
    vs2.check_adj_full()


def test_synthetic_energy_balance():
    sim = synthetic_box_sim(2.0, 3.0, 2.5, h=0.25, Nt=60, lossy=True,
                            insig_type="hann10", diff_source=False)
    eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, energy_on=True)
    eng.run_all()
    from pffdtd_jax.utils import rel_diff

    n = eng.n
    live = eng.E_in[:n] > 0
    bal = rel_diff((eng.H_tot[:n] + eng.E_lost[:n])[live], eng.E_in[:n][live])
    assert np.max(np.abs(bal)) < 1e-10
