"""fp32 stability: long runs with the EPS-shifted diagonal must stay finite
and dissipate (the reference's single-precision safeguard discipline,
fdtd_common.h:43-71 / README.md:71-74)."""

import numpy as np

from pffdtd_jax.demo import synthetic_box_sim
from pffdtd_jax.engine.jax_engine import JaxEngine


def test_fp32_long_run_stays_bounded():
    sim = synthetic_box_sim(2.0, 1.6, 1.3, h=0.1, Nt=5000, lossy=True,
                            insig_type="impulse")  # impulse => diff source
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    u = eng.run(verbose=False)
    assert np.isfinite(u).all()
    a = np.abs(u)
    assert a[:, -500:].max() < a.max()  # lossy walls dissipate


def test_fp32_rigid_no_dc_growth():
    """Rigid room + diff'd impulse: no DC buildup over thousands of steps."""
    sim = synthetic_box_sim(2.0, 1.6, 1.3, h=0.1, Nt=4000, lossy=False,
                            insig_type="impulse")
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    u = eng.run(verbose=False)
    assert np.isfinite(u).all()
    # bounded oscillation: last-quarter max comparable to global max
    assert np.abs(u[:, -1000:]).max() < 4 * np.abs(u[:, :1000]).max()
