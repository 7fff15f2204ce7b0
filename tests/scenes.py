"""Small scenes shared by the engine, energy and sharding tests.

Each function returns SimData small enough for a CPU test; together they
cover both grids (Cartesian, FCC, folded FCC), both boundary kinds (rigid
and frequency-dependent lossy), off-plane boundary nodes (the raked
ceiling), an odd x extent and more than 256 receiver taps.
"""

import numpy as np

from pffdtd_jax.prep import fold_fcc_sim
from pffdtd_jax.scene_setup import mats_from_DEF_list, sim_setup_from_room

from conftest import make_shoebox

DEF3 = np.array([[2.0, 5.0, 30.0],
                 [1.0, 10.0, 300.0],
                 [0.5, 8.0, 3000.0]])


def shoebox_sim(fcc=False, lossy=False, h=None, duration=0.02,
                sig="hann10", Lx=2.0, Ly=3.0, Lz=2.5, Rxyz=None):
    rg = make_shoebox(Lx=Lx, Ly=Ly, Lz=Lz,
                      mats=["w"] * 6 if lossy else None)
    if Rxyz is not None:
        rg.Rxyz = np.asarray(Rxyz, np.float64)
    md = mats_from_DEF_list([DEF3] if lossy else [])
    return sim_setup_from_room(
        rg, md, duration=duration, insig_type=sig,
        h=h or (0.2 if fcc else 0.25), fcc_flag=fcc, diff_source=False,
        vox_backend="numpy", block_size=16)


def sloped_sim():
    import __graft_entry__ as ge

    return ge._sloped_sim(Nt=24)


def many_taps_sim():
    """40 receivers: 320 trilinear taps, past the 256-tap mark."""
    g = np.linspace(0.5, 1.5, 4)
    R = np.array([[x, y, z] for x in g[:2] for y in np.linspace(0.6, 2.4, 5)
                  for z in g]) + 0.01
    return shoebox_sim(lossy=True, Rxyz=R)


SCENES = {
    "cart_rigid": lambda: shoebox_sim(),
    "cart_lossy": lambda: shoebox_sim(lossy=True),
    "fcc_rigid": lambda: shoebox_sim(fcc=True),
    "fcc_lossy": lambda: shoebox_sim(fcc=True, lossy=True),
    "folded_rigid": lambda: fold_fcc_sim(shoebox_sim(fcc=True)),
    "folded_lossy": lambda: fold_fcc_sim(shoebox_sim(fcc=True, lossy=True)),
    "sloped": sloped_sim,
    # Lx chosen so that Nx is odd
    "odd_nx": lambda: shoebox_sim(lossy=True, Lx=2.25),
    "many_taps": many_taps_sim,
}


def make(name):
    return SCENES[name]()
