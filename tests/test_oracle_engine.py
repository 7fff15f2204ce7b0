"""NumPy oracle engine: energy conservation to machine precision.

This is the reference project's strongest correctness signal (SURVEY.md §4.2):
the discrete Hamiltonian H_tot plus accumulated losses E_lost must equal the
injected energy E_in to machine epsilon, exercising the air update, rigid and
lossy boundaries, ABCs and source bookkeeping all at once.
"""

import numpy as np
import pytest

from pffdtd_jax.engine.numpy_ref import NumpyEngine
from pffdtd_jax.scene_setup import mats_from_DEF_list, sim_setup_from_room

from conftest import make_shoebox

# a 3-branch frequency-dependent material (D, E, F triplets)
DEF3 = np.array([[2.0, 5.0, 30.0],
                 [1.0, 10.0, 300.0],
                 [0.5, 8.0, 3000.0]])


def _setup(fcc=False, mats=None, DEF_list=(), sig="hann10", duration=0.02,
           h=0.25, diff=False):
    rg = make_shoebox(mats=mats)
    md = mats_from_DEF_list(list(DEF_list))
    return sim_setup_from_room(
        rg, md, duration=duration, insig_type=sig, h=h, fcc_flag=fcc,
        diff_source=diff, vox_backend="numpy", block_size=16)


def _balance(eng):
    n = eng.n
    tot = eng.H_tot[:n] + eng.E_lost[:n]
    live = eng.E_in[:n] > 0
    assert live.any()
    from pffdtd_jax.utils import rel_diff

    return np.max(np.abs(rel_diff(tot[live], eng.E_in[:n][live])))


def test_energy_balance_rigid_cart():
    sim = _setup()
    eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, energy_on=True)
    eng.run_all()
    assert _balance(eng) < 1e-10
    # waves actually reached the receivers
    assert np.max(np.abs(eng.u_out)) > 0


def test_energy_balance_lossy_cart():
    sim = _setup(mats=["w"] * 6, DEF_list=[DEF3])
    eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, energy_on=True)
    eng.run_all()
    assert _balance(eng) < 1e-10
    # losses are actually accumulating (absorbing walls)
    assert eng.E_lost[eng.Nt] > 0


def test_energy_balance_fcc():
    sim = _setup(fcc=True, mats=["w"] * 6, DEF_list=[DEF3], h=0.2)
    eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, energy_on=True)
    eng.run_all()
    assert _balance(eng) < 1e-10


def test_rigid_room_conserves_energy_without_abc_loss():
    """With a hann pulse in a closed rigid room, H_tot stays ~E_in once the
    source stops (ABC layers sit outside the room and see ~nothing early on)."""
    sim = _setup(sig="hann10", duration=0.015)
    eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, energy_on=True)
    eng.run_all()
    n0 = 12  # source finished
    E_final = eng.E_in[n0]
    assert E_final > 0
    drift = np.abs(eng.H_tot[n0:] + eng.E_lost[n0:eng.Nt] - eng.E_in[n0:eng.Nt])
    assert np.max(drift / E_final) < 1e-12


def test_diff_source_energy():
    sim = _setup(sig="impulse", diff=True, duration=0.01)
    eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats, energy_on=True)
    eng.run_all()
    assert _balance(eng) < 1e-9
