"""500k-step fp32 stability stress.

The reference guards single precision two ways (fdtd_common.h:43-71,
fdtd_data.h:186-199): the (1+EPS) diagonal shift AND round-toward-zero
intrinsics on the off-diagonal FMAs.  This framework keeps only the EPS
shift (RTZ is a per-instruction CUDA rounding mode with no XLA
equivalent); the written argument for why EPS alone suffices is in
PARITY.md, and THIS probe is its empirical backing at 10x production
RIR length: a sealed rigid box (zero dissipation - the worst case: any
rounding-induced eigenvalue outside the unit circle compounds for 500k
steps with nothing to damp it) and a lossy+ABC box (the full fp32
physics).  PASS = tail RMS does not grow.

Run: python -c "exec(open('probes/fp32_500k.py').read())"   (~10 min)
"""
import os
import time

import numpy as np

from pffdtd_jax.demo import synthetic_box_sim
from pffdtd_jax.engine.jax_engine import JaxEngine

DEF11 = np.array([[d, e, f] for d, e, f in zip(
    np.geomspace(0.4, 40.0, 11),
    np.geomspace(2.0, 80.0, 11),
    np.geomspace(20.0, 2.0e5, 11))])

NS = int(os.environ.get("NS", "500000"))
for lossy in (False, True):
    sim = synthetic_box_sim(4.0, 3.1, 2.6, h=0.04, Nt=NS, lossy=lossy,
                            insig_type="hann10", diff_source=False,
                            DEF=DEF11 if lossy else None, open_top=lossy)
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    t0 = time.time()
    eng.run(verbose=False, chunk=10000)
    u = eng.u_out[0]
    assert np.isfinite(u).all()
    a = np.sqrt(np.mean(u[: NS // 4] ** 2))
    b = np.sqrt(np.mean(u[-NS // 4:] ** 2))
    print(f"RESULT fp32_500k lossy={int(lossy)}: tail/head RMS "
          f"{b / a:.4f}  (head {a:.3e}, tail {b:.3e}, "
          f"{time.time() - t0:.0f}s)", flush=True)
    assert b / a < 1.5, (a, b)
print("FP32 500K OK", flush=True)
