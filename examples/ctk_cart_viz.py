"""CTK church, Cartesian scheme, visualization run.

The canonical low-fmax config (reference: test_script_CTK_cart_viz.py):
dhann30 pulse for viz, fp64-friendly, with slice-animation frames.

Run:  python examples/ctk_cart_viz.py [REF_DATA] [OUT_DIR]
"""

import sys

import numpy as np

REF = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
OUT = sys.argv[2] if len(sys.argv) > 2 else "out/ctk_cart_viz"

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
    from pffdtd_jax.viz import render_animation

    sim_setup(
        model_json_file=f"{REF}/models/CTK_Church/model_export.json",
        mat_folder=f"{REF}/materials",
        mat_files_dict=CTK_MATS,
        source_num=1,
        insig_type="dhann30",      # symmetric pulse for viz
        diff_source=False,
        duration=0.1,
        Tc=20, rh=50,
        fcc_flag=False,
        PPW=7.5, fmax=500.0,
        save_folder=OUT,
    )
    eng = JaxEngine(OUT, dtype=np.float64, energy_on=True)
    eng.run(chunk=64)
    eng.save_outputs(OUT)
    print("energy balance:", np.abs(eng.energy_balance()).max())
    frames = render_animation(JaxEngine(OUT, dtype=np.float32), frames=16,
                              out_dir=f"{OUT}/frames")
    print(f"wrote {len(frames)} animation frames to {OUT}/frames")
