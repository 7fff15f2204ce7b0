"""Regenerate the bundled CTK / Musikverein material library.

The reference ships data/materials/*.h5 produced by its build_mats.py
(reference build_mats.py:24-64); this script regenerates the same
library from the same published octave-band Sabine absorption tables
(16 Hz - 16 kHz centres, 11 bands) through our 11-band fit
(pffdtd_jax.materials.admittance.fit_to_Sabs_oct_11), closing the
layer-B reproducibility gap: a user can rebuild or extend the library
without the reference checkout.

    python examples/build_material_library.py [out_dir]
"""
import sys
from pathlib import Path

import numpy as np

from pffdtd_jax.materials.admittance import (
    convert_R_to_Yn, convert_Sabs_to_Yn, fit_to_Sabs_oct_11,
    write_freq_dep_mat, write_freq_ind_mat_from_Yn)

# Published Sabine coefficients (16 Hz..16 kHz octave centres) for the two
# example venues — physical measurement data, reference build_mats.py:24-52.
SABS_TABLES = {
    "mv_chairs": [0.22, 0.22, 0.22, 0.22, 0.26, 0.3, 0.33, 0.34, 0.34,
                  0.34, 0.34],
    "mv_floor": [0.14, 0.14, 0.14, 0.14, 0.1, 0.06, 0.08, 0.1, 0.1,
                 0.1, 0.1],
    "mv_plasterboard": [0.15, 0.15, 0.15, 0.15, 0.1, 0.06, 0.04, 0.04,
                        0.05, 0.05, 0.05],
    "mv_window": [0.35, 0.35, 0.35, 0.35, 0.25, 0.18, 0.12, 0.07, 0.04,
                  0.04, 0.04],
    "mv_wood": [0.25, 0.25, 0.25, 0.25, 0.15, 0.1, 0.09, 0.08, 0.07,
                0.07, 0.07],
    "ctk_acoustic_panel": [0.2, 0.2, 0.42, 0.89, 1, 1, 1, 1, 1, 1, 1],
    "ctk_altar": [0.25, 0.25, 0.25, 0.25, 0.15, 0.1, 0.09, 0.08, 0.07,
                  0.07, 0.07],
    "ctk_audience": [0.1, 0.1, 0.1, 0.1, 0.07, 0.08, 0.1, 0.1, 0.11,
                     0.11, 0.11],
    "ctk_carpet": [0.08, 0.08, 0.08, 0.08, 0.24, 0.57, 0.69, 0.71, 0.73,
                   0.73, 0.73],
    "ctk_ceiling": [0.19, 0.19, 0.19, 0.19, 0.06, 0.05, 0.08, 0.07, 0.05,
                    0.05, 0.05],
    "ctk_chair": [0.44, 0.44, 0.44, 0.44, 0.56, 0.67, 0.74, 0.83, 0.87,
                  0.87, 0.87],
    "ctk_tile": [0.015, 0.015, 0.015, 0.015, 0.015, 0.005, 0.005, 0.005,
                 0.005, 0.005, 0.005],
    "ctk_walls": [0.19, 0.19, 0.19, 0.19, 0.06, 0.05, 0.08, 0.07, 0.05,
                  0.05, 0.05],
    "ctk_window": [0.35, 0.35, 0.35, 0.35, 0.25, 0.18, 0.12, 0.07, 0.04,
                   0.04, 0.04],
}


def build_library(out_dir):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name, sabs in SABS_TABLES.items():
        fit_to_Sabs_oct_11(np.asarray(sabs, float),
                           filename=out / f"{name}.h5")
        print(f"  wrote {name}.h5")
    # frequency-independent examples (reference build_mats.py:56-61)
    write_freq_ind_mat_from_Yn(convert_R_to_Yn(0.90), out / "R90_mat.h5")
    write_freq_ind_mat_from_Yn(convert_R_to_Yn(0.5), out / "R50.h5")
    write_freq_ind_mat_from_Yn(convert_Sabs_to_Yn(0.5), out / "a50.h5")
    # direct DEF input example (reference build_mats.py:64)
    write_freq_dep_mat(np.array([[0, 1.0, 0], [2, 3, 4]]),
                       out / "ex_mat.h5")
    print(f"  wrote R90_mat.h5 R50.h5 a50.h5 ex_mat.h5")
    return out


if __name__ == "__main__":
    build_library(sys.argv[1] if len(sys.argv) > 1 else "data/materials")
