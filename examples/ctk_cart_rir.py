"""CTK church, Cartesian scheme, single-precision RIR run.

The canonical production config (reference: test_script_CTK_cart_gpu.py):
impulse + diff_source (the fp32 safeguard), fmax=1400 Hz at 10.5 PPW,
full post-processing chain to 48 kHz wav files.

Run:  python examples/ctk_cart_rir.py [REF_DATA] [OUT_DIR]
"""

import sys

import numpy as np

REF = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
OUT = sys.argv[2] if len(sys.argv) > 2 else "out/ctk_cart_rir"

CTK_MATS = {
    "AcousticPanel": "ctk_acoustic_panel.h5",
    "Altar": "ctk_altar.h5",
    "Carpet": "ctk_carpet.h5",
    "Ceiling": "ctk_ceiling.h5",
    "Glass": "ctk_window.h5",
    "PlushChair": "ctk_chair.h5",
    "Tile": "ctk_tile.h5",
    "Walls": "ctk_walls.h5",
}

if __name__ == "__main__":
    from pffdtd_jax.scene_setup import sim_setup
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.analysis.process_outputs import ProcessOutputs

    sim_setup(
        model_json_file=f"{REF}/models/CTK_Church/model_export.json",
        mat_folder=f"{REF}/materials",
        mat_files_dict=CTK_MATS,
        source_num=1,
        insig_type="impulse",
        diff_source=True,          # single-precision DC safeguard
        duration=3.0,
        Tc=20, rh=50,
        fcc_flag=False,
        PPW=10.5, fmax=1400.0,
        save_folder=OUT,
    )
    eng = JaxEngine(OUT, dtype=np.float32)
    eng.run(chunk=2000)
    eng.save_outputs(OUT)
    eng.print_last_samples(5)

    po = ProcessOutputs(OUT)
    po.initial_process(fcut=10.0, N_order=4)
    po.resample(48e3)
    po.apply_lowpass(fcut=1400.0, N_order=8, symmetric=True)
    po.apply_modal_filter()
    po.save_h5()
    po.save_wav()
