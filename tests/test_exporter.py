"""Scene exporter: the plugin-semantics authoring path, round-tripped.

Covers the RoomExport.rb classification table (sides 0-3 + _TOFIX
quarantine, RoomExport.rb:86-112), vertex dedup, unit conversion, CSV
intake with bounds warnings, and a full round trip:
build faces -> model_export.json -> RoomGeo -> sim_setup -> engine run
with the machine-precision energy oracle.
"""

import json

import numpy as np
import pytest

from pffdtd_jax.geometry.exporter import (INCHES2METRES, SceneExporter,
                                          export_box_room)
from pffdtd_jax.geometry.room import RoomGeo


def test_paint_classification(tmp_path):
    ex = SceneExporter()
    sq = np.array([(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)], float)
    ex.add_face(sq, front="wood")                      # sides 2
    ex.add_face(sq + (0, 0, 1), back="wood")           # sides 1
    ex.add_face(sq + (0, 0, 2), front="wood", back="wood")   # sides 3
    ex.add_face(sq + (0, 0, 3))                        # rigid, sides 0
    ex.add_face(sq + (0, 0, 4), front="wood", back="glass")  # _TOFIX
    s = ex.export(tmp_path / "model_export.json",
                  [[0.5, 0.5, 0.5]], [[0.6, 0.6, 0.6]])
    assert s["n_faces"] == 5
    assert s["n_faces_rigid"] == 1
    assert s["n_faces_tofix"] == 1
    assert len(ex.tofix) == 1
    data = json.loads((tmp_path / "model_export.json").read_text())
    mh = data["mats_hash"]
    assert set(mh) == {"wood", "_RIGID"}
    assert sorted(set(mh["wood"]["sides"])) == [1, 2, 3]
    assert set(mh["_RIGID"]["sides"]) == {0}
    # glass never exported (its only face was quarantined)
    assert any("_TOFIX" in w for w in s["warnings"])


def test_dedup_units_and_bounds(tmp_path):
    ex = SceneExporter(unit_scale=INCHES2METRES)
    sq = np.array([(0, 0, 0), (100, 0, 0), (100, 100, 0), (0, 100, 0)],
                  float)
    ex.add_face(sq, front="m")
    ex.add_face(sq[::-1], back="m")  # same 4 points again
    s = ex.export(tmp_path / "m.json", [[1.0, 1.0, 0.0]],
                  [[99.0, 99.0, 99.0]])
    assert s["npts"] == 4            # dedup across both faces
    data = json.loads((tmp_path / "m.json").read_text())
    pts = np.asarray(data["mats_hash"]["m"]["pts"])
    assert np.isclose(pts.max(), 100 * INCHES2METRES)
    assert any("outside the model bounding box" in w for w in s["warnings"])


def test_csv_intake(tmp_path):
    (tmp_path / "sources.csv").write_text("x,y,z\n0.5;0.5;0.5\n")
    (tmp_path / "receivers.csv").write_text("1.0 1.0 1.0\n")
    s = export_box_room(tmp_path / "model_export.json", (2.0, 2.0, 2.0),
                        {"x0": "wood", "z0": "wood"},
                        tmp_path / "sources.csv", tmp_path / "receivers.csv")
    assert s["nmats"] == 2           # wood + _RIGID (4 unpainted walls)
    assert not s["warnings"]


def test_roundtrip_sim(tmp_path):
    """Exporter output must drive the FULL pipeline: RoomGeo -> setup ->
    oracle engine with the energy balance at machine precision."""
    from pffdtd_jax.engine.numpy_ref import NumpyEngine
    from pffdtd_jax.scene_setup import mats_from_DEF_list, sim_setup_from_room
    from pffdtd_jax.utils import rel_diff

    path = tmp_path / "model_export.json"
    export_box_room(path, (2.0, 3.0, 2.5),
                    {k: "walls" for k in ("x0", "x1", "y0", "y1",
                                          "z0", "z1")},
                    [[1.1, 1.8, 1.2]], [[0.6, 0.9, 1.0]])
    rg = RoomGeo(path)
    assert rg.Nmat == 1 and "walls" in rg.mat_str
    mats = mats_from_DEF_list([np.array([[2.0, 5.0, 30.0]])])
    sim = sim_setup_from_room(rg, mats, duration=0.015, insig_type="hann10",
                              h=0.2, save_folder=tmp_path / "sim")
    eng = NumpyEngine(tmp_path / "sim", energy_on=True)
    u = eng.run_all()
    live = eng.E_in[:eng.n] > 0
    bal = np.abs(rel_diff(eng.H_tot[:eng.n][live] + eng.E_lost[:eng.n][live],
                          eng.E_in[:eng.n][live])).max()
    assert bal < 1e-10, bal
    assert np.abs(u).max() > 0
