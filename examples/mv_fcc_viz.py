"""Musikverein hall, FCC scheme, visualization run.

The canonical MV viz config (reference: test_script_MV_fcc_viz.py):
dhann30 pulse, source 3, fmax 1 kHz, voxelization debug draw at setup
(per-material boundary nodes + cut adjacency legs + room wireframe —
the reference's polyscope/mayavi draw, rendered with matplotlib), then
a short run with slice-animation frames (the reference's `--plot`).

Run:  python examples/mv_fcc_viz.py [REF_DATA] [OUT_DIR] [FMAX]
"""

import sys

import numpy as np

REF = sys.argv[1] if len(sys.argv) > 1 else "/root/reference/data"
OUT = sys.argv[2] if len(sys.argv) > 2 else "out/mv_fcc_viz"
FMAX = float(sys.argv[3]) if len(sys.argv) > 3 else 1000.0

MV_MATS = {
    "Floor": "mv_floor.h5",
    "Chairs": "mv_chairs.h5",
    "Plasterboard": "mv_plasterboard.h5",
    "Window": "mv_window.h5",
    "Wood": "mv_wood.h5",
}

if __name__ == "__main__":
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.scene_setup import sim_setup
    from pffdtd_jax.viz import render_animation

    sim_setup(
        model_json_file=f"{REF}/models/Musikverein_ConcertHall"
                        "/model_export.json",
        mat_folder=f"{REF}/materials",
        mat_files_dict=MV_MATS,
        source_num=3,
        insig_type="dhann30",
        diff_source=False,
        duration=0.1,
        Tc=20, rh=50,
        fcc_flag=True,
        PPW=5.6, fmax=FMAX,
        save_folder=OUT,
        draw_vox=True, draw_backend="save",   # voxelization.png
    )
    frames = render_animation(JaxEngine(OUT, dtype=np.float32), frames=16,
                              out_dir=f"{OUT}/frames")
    print(f"wrote {len(frames)} animation frames to {OUT}/frames")
