"""Scene interchange round-trips + viz smoke tests."""

import numpy as np

from pffdtd_jax.geometry.room import RoomGeo
from pffdtd_jax.geometry.scene_io import (read_positions_csv,
                                          room_to_model_json,
                                          write_model_json)

from conftest import make_shoebox


def test_positions_csv_sniffing(tmp_path):
    for text, n in [("1.0,2.0,3.0\n4,5,6\n", 2),
                    ("x y z\n1 2 3\n", 1),
                    ("1;2;3\n", 1)]:
        f = tmp_path / "pos.csv"
        f.write_text(text)
        pos = read_positions_csv(f)
        assert pos.shape == (n, 3)


def test_model_json_roundtrip(tmp_path):
    rg = make_shoebox(mats=["a", "a", "b", "b", "c", "c"])
    f = tmp_path / "model_export.json"
    room_to_model_json(f, rg)
    rg2 = RoomGeo(f)
    assert rg2.Nmat == rg.Nmat
    assert rg2.tris.shape == rg.tris.shape
    assert np.allclose(sorted(rg2.mat_area), sorted(rg.mat_area))
    assert np.isclose(rg2.vol, rg.vol)
    assert np.allclose(rg2.Sxyz, rg.Sxyz)


def test_reference_csv_files():
    from pathlib import Path

    p = Path("/root/reference/data/models/CTK_Church")
    if not p.exists():
        return
    s = read_positions_csv(p / "sources.csv")
    r = read_positions_csv(p / "receivers.csv")
    assert s.shape[1] == 3 and r.shape[1] == 3 and len(s) >= 1


def test_rel_diff_zero_guard():
    from pffdtd_jax.utils import rel_diff

    d = rel_diff(np.array([0.0, 4.0]), np.array([0.0, 4.0 + 4e-16]))
    assert np.isfinite(d).all()
    assert d[0] == 0.0
    assert abs(d[1]) < 1e-15


def test_draw_vox_hook(tmp_path):
    """sim_setup's draw_vox hook renders the voxelization to a PNG
    (reference parity: sim_setup.py:44-45 draw path)."""
    from pffdtd_jax.scene_setup import sim_setup_from_room

    rg = make_shoebox()
    sim_setup_from_room(rg, duration=5e-4, fmax=700.0, PPW=7.7,
                        save_folder=tmp_path, draw_vox=True)
    assert (tmp_path / "voxelization.png").stat().st_size > 1000


def test_viz_smoke(tmp_path):
    from pffdtd_jax.demo import synthetic_box_sim
    from pffdtd_jax.engine.numpy_ref import NumpyEngine
    from pffdtd_jax.viz import plot_rirs, plot_wave_slices

    sim = synthetic_box_sim(2.0, 1.6, 1.3, h=0.12, Nt=30, lossy=False,
                            insig_type="hann10", diff_source=False)
    eng = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                      mats=sim.mats)
    eng.run_all()
    f1 = tmp_path / "slices.png"
    plot_wave_slices(eng.u1, sim.vox, in_ixyz=sim.comms.in_ixyz, fname=f1)
    assert f1.exists() and f1.stat().st_size > 1000
    f2 = tmp_path / "rirs.png"
    plot_rirs(eng.u_out, 1 / sim.consts.Ts, fname=f2)
    assert f2.exists()


def test_vox_viz_smoke(tmp_path):
    from pffdtd_jax.viz import plot_voxelization
    from pffdtd_jax.voxelizer import CartGrid, VoxScene

    rg = make_shoebox(mats=["a"] * 6)
    cg = CartGrid(h=0.25, offset=3.5, bmin=rg.bmin, bmax=rg.bmax)
    vs = VoxScene(rg, cg)
    vs.calc_adj(backend="numpy", block_size=16)
    f = tmp_path / "vox.png"
    plot_voxelization(vs, fname=f)
    assert f.exists()
    # the full debug draw: cut-leg segments + room wireframe overlay
    # (reference vox_scene.py:531-601 draw())
    f3 = tmp_path / "vox_legs.png"
    plot_voxelization(vs, fname=f3, cut_legs=True, room=rg)
    assert f3.exists()


def test_live_slice_view(tmp_path):
    """run_plot parity: live view callback renders frames during run()."""
    import numpy as np

    from pffdtd_jax.demo import synthetic_box_sim
    from pffdtd_jax.engine.jax_engine import JaxEngine
    from pffdtd_jax.viz import LiveSliceView

    sim = synthetic_box_sim(1.6, 1.3, 1.1, h=0.14, Nt=12, lossy=True,
                            insig_type="hann10", diff_source=False)
    eng = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, dtype=np.float32)
    view = LiveSliceView(eng, show=False, out_dir=tmp_path / "live")
    eng.run(verbose=False, chunk=4, on_chunk=view)
    frames = sorted((tmp_path / "live").glob("live_*.png"))
    assert len(frames) == 3 and frames[0].stat().st_size > 0
