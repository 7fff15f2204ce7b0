"""The material-library regeneration script reproduces the bundled .h5s.

The reference ships data/materials/*.h5 built by build_mats.py:24-64 from
published octave-band Sabine tables; examples/build_material_library.py
regenerates them through our fit.  Nelder-Mead details differ between
scipy versions, so the equivalence criterion is the physics the engine
consumes: the absorption curve 1-|R(f)|^2 of the regenerated DEF matches
the bundled one within fit tolerance across 20 Hz-16 kHz."""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))

REF_MATS = Path("/root/reference/data/materials")


def _absorption(DEF, fv):
    from pffdtd_jax.materials.admittance import compute_Rf_from_DEF

    jw = 1j * 2 * np.pi * fv
    Rf, _, _, _ = compute_Rf_from_DEF(jw, DEF[:, 0], DEF[:, 1], DEF[:, 2])
    return 1.0 - np.abs(Rf) ** 2


@pytest.mark.skipif(not REF_MATS.exists(), reason="reference mount absent")
@pytest.mark.parametrize("name", ["mv_wood", "ctk_carpet", "mv_window"])
def test_regenerated_matches_bundled(tmp_path, name):
    import h5py
    from build_material_library import SABS_TABLES
    from pffdtd_jax.materials.admittance import fit_to_Sabs_oct_11

    DEF = fit_to_Sabs_oct_11(np.asarray(SABS_TABLES[name], float),
                             filename=tmp_path / f"{name}.h5")
    with h5py.File(REF_MATS / f"{name}.h5", "r") as f:
        DEF_ref = np.asarray(f["DEF"])
    assert DEF.shape == DEF_ref.shape == (11, 3)
    fv = np.logspace(np.log10(20.0), np.log10(16e3), 400)
    a_new = _absorption(DEF, fv)
    a_ref = _absorption(DEF_ref, fv)
    assert np.max(np.abs(a_new - a_ref)) < 0.05
    with h5py.File(tmp_path / f"{name}.h5", "r") as f:
        assert np.allclose(np.asarray(f["DEF"]), DEF)


def test_build_library_writes_all(tmp_path):
    """The script writes every library entry (fits stubbed to one call)."""
    import build_material_library as bml

    written = []
    orig = bml.fit_to_Sabs_oct_11

    def fake_fit(sabs, filename=None):
        written.append(Path(filename).name)
        return orig(np.asarray(sabs), filename=filename) if False else \
            np.ones((11, 3))

    bml.fit_to_Sabs_oct_11 = fake_fit
    try:
        bml.build_library(tmp_path)
    finally:
        bml.fit_to_Sabs_oct_11 = orig
    assert sorted(written) == sorted(f"{n}.h5" for n in bml.SABS_TABLES)
    for extra in ("R90_mat.h5", "R50.h5", "a50.h5", "ex_mat.h5"):
        assert (tmp_path / extra).exists()
