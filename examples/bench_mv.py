"""Benchmark on the real Musikverein hall (the reference's benchmark model).

Reference conditions (benchmarks/README.md): 11-branch materials, impulse +
diff source, single precision, MVPS = Npts*Nsamples/runtime/1e6.  fmax is
capped by the memory of one device (the reference's headline rows run
1e9..32e9 voxels across multi-GPU boxes).

Run: python examples/bench_mv.py [FMAX=2000] [NT=100] [FCC=1]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FMAX = float(sys.argv[1]) if len(sys.argv) > 1 else 2000.0
NT = int(sys.argv[2]) if len(sys.argv) > 2 else 100
FCC = (sys.argv[3] if len(sys.argv) > 3 else "1") == "1"

REF = "/root/reference/data"
MV_MATS = {
    "Floor": "mv_floor.h5",
    "Chairs": "mv_chairs.h5",
    "Plasterboard": "mv_plasterboard.h5",
    "Window": "mv_window.h5",
    "Wood": "mv_wood.h5",
}

if __name__ == "__main__":
    from pffdtd_jax.geometry.room import RoomGeo
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.scene_setup import pack_mats, sim_setup_from_room
    from pffdtd_jax.prep import fold_fcc_sim, rotate_sim, sort_sim

    t0 = time.time()
    rg = RoomGeo(f"{REF}/models/Musikverein_ConcertHall/model_export.json")
    # drop receivers too close to seats for this resolution (the bundled
    # ones assume the reference's fmax >= 3.2 kHz grids)
    keep = [r for r in rg.Rxyz
            if np.linalg.norm(rg.tris_pre.cent - r, axis=-1).min() > 0.6]
    rg.Rxyz = np.asarray(keep if keep else rg.Sxyz[:1] + 2.0)
    mats = pack_mats(rg.mat_str, MV_MATS, f"{REF}/materials")
    sim = sim_setup_from_room(
        rg, mats, duration=NT * 1e-4, insig_type="impulse",
        diff_source=True, fmax=FMAX, PPW=5.6 if FCC else 7.75,
        fcc_flag=FCC, check_adj=False)
    if FCC:
        sim = sort_sim(fold_fcc_sim(rotate_sim(sim)))
    else:
        sim = sort_sim(rotate_sim(sim))
    npts = sim.vox.Nx * sim.vox.Ny * sim.vox.Nz
    print(f"setup {time.time() - t0:.1f}s: grid {sim.vox.Nx}x{sim.vox.Ny}x"
          f"{sim.vox.Nz} = {npts / 1e6:.0f} Mvox, Nb={sim.vox.Nb}",
          file=sys.stderr)

    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    nt = min(NT, eng.Nt)
    eng.run(nt=nt, verbose=False)   # compile
    eng.run(nt=nt, verbose=False)   # timed
    assert np.isfinite(eng.u_out).all()
    print(json.dumps({
        "metric": f"mv_{'fcc' if FCC else 'cart'}_fmax{int(FMAX)}",
        "value": round(eng.mvps, 1),
        "unit": "Mvox/s",
        "vs_baseline": round(eng.mvps / 52512.6, 4),
    }))
