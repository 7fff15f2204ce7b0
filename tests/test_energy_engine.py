"""On-device energy balance of the JAX engine in fp64, per scene.

H_tot + E_lost == E_in to machine precision exercises the air update,
rigid and lossy boundaries, ABCs and source bookkeeping at once
(sim_fdtd.py:587-620; the reference's strongest invariant).
"""

import numpy as np
import pytest

from pffdtd_jax.engine.jax_engine import JaxEngine

import scenes

ENERGY_SCENES = ["cart_rigid", "cart_lossy", "fcc_rigid", "fcc_lossy",
                 "folded_rigid", "folded_lossy", "sloped"]


@pytest.mark.parametrize("rigid", ["dense", "sparse"])
@pytest.mark.parametrize("scene", ENERGY_SCENES)
def test_on_device_energy_balance(scene, rigid):
    sim = scenes.make(scene)
    j = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                  mats=sim.mats, dtype=np.float64, energy_on=True,
                  rigid=rigid)
    j.run(verbose=False)
    assert np.abs(j.u_out).max() > 0
    assert np.max(np.abs(j.energy_balance())) < 1e-10
    lossy = bool((sim.vox.mat_bn >= 0).any())
    # absorbing walls accumulate losses; rigid rooms lose only to the ABCs
    assert (j.E_lost[-1] > 0) or not lossy
