"""Musikverein hall, 13-point FCC scheme, single-precision RIR run.

The canonical FCC production config (reference: test_script_MV_fcc_gpu.py):
impulse + diff_source, FCC folded grid prepared via rotate/fold/sort
(the multi-device-friendly layout).

Run:  python examples/mv_fcc_rir.py [REF_DATA] [OUT_DIR] [FMAX]
"""

import sys

import numpy as np

REF = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
OUT = sys.argv[2] if len(sys.argv) > 2 else "out/mv_fcc_rir"
FMAX = float(sys.argv[3]) if len(sys.argv) > 3 else 1000.0

MV_MATS = {
    "Floor": "mv_floor.h5",
    "Chairs": "mv_chairs.h5",
    "Plasterboard": "mv_plasterboard.h5",
    "Window": "mv_window.h5",
    "Wood": "mv_wood.h5",
}

if __name__ == "__main__":
    from pffdtd_jax.scene_setup import sim_setup
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.analysis.process_outputs import ProcessOutputs

    sim_setup(
        model_json_file=f"{REF}/models/Musikverein_ConcertHall/"
                        "model_export.json",
        mat_folder=f"{REF}/materials",
        mat_files_dict=MV_MATS,
        source_num=3,
        insig_type="impulse",
        diff_source=True,
        duration=2.0,
        Tc=20, rh=50,
        fcc_flag=True,
        PPW=5.6, fmax=FMAX,       # FCC runs at lower PPW (CFL 0.999)
        save_folder=OUT,
        save_folder_gpu=OUT,      # rotate + FCC-fold + sort in place
    )
    eng = JaxEngine(OUT, dtype=np.float32)
    eng.run(chunk=2000)
    eng.save_outputs(OUT)

    po = ProcessOutputs(OUT)
    po.initial_process(fcut=10.0, N_order=4)
    po.resample(48e3)
    po.apply_lowpass(fcut=FMAX, N_order=8, symmetric=True)
    po.apply_stokes_filter()
    po.save_h5()
    po.save_wav()
