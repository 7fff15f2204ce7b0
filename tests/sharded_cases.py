"""Shared check: the slab-sharded engine against the single-device engine.

The reference's multi-GPU criterion is bitwise-equal outputs across device
counts (SURVEY.md §4.7); on the CPU mesh we require exact equality in fp64
against the single-device engine's sparse-rigid formulation, which the
sharded step shares.
"""

import numpy as np

from pffdtd_jax.engine.jax_engine import JaxEngine
from pffdtd_jax.parallel.sharded_engine import make_mesh, make_sharded_engine
from pffdtd_jax.prep import pad_x

import scenes

SHARDED_SCENES = ["cart_rigid", "cart_lossy", "fcc_lossy", "folded_lossy",
                  "sloped"]


def check_sharded_matches_single(scene, D):
    sim = pad_x(scenes.make(scene), D, min_rows=4)
    j1 = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                   mats=sim.mats, dtype=np.float64, rigid="sparse")
    j1.run(verbose=False)
    js = make_sharded_engine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                             mats=sim.mats, mesh=make_mesh(D),
                             dtype=np.float64)
    assert js.D == D and js.data.grid.Nx == sim.vox.Nx
    js.run(verbose=False)
    assert np.abs(j1.u_out).max() > 0
    assert np.array_equal(j1.u_out, js.u_out), (
        f"max abs diff {np.abs(j1.u_out - js.u_out).max():.3e}")
