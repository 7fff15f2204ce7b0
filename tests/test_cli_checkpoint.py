"""Chunked runs, checkpoint/resume, and the CLI."""

import numpy as np

from pffdtd_jax.demo import synthetic_box_sim
from pffdtd_jax.engine.jax_engine import JaxEngine
from pffdtd_jax.scene_setup import save_sim_data


def _sim():
    return synthetic_box_sim(2.2, 1.8, 1.5, h=0.12, Nt=48, lossy=True,
                             insig_type="hann10", diff_source=False)


def test_chunked_run_matches_single():
    sim = _sim()
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms, mats=sim.mats,
              dtype=np.float64)
    a = JaxEngine(**kw)
    a.run(verbose=False)
    b = JaxEngine(**kw)
    b.run(verbose=False, chunk=13)
    assert np.array_equal(a.u_out, b.u_out)


def test_checkpoint_resume(tmp_path):
    sim = _sim()
    kw = dict(consts=sim.consts, vox=sim.vox, comms=sim.comms, mats=sim.mats,
              dtype=np.float64)
    ck = tmp_path / "state.npz"
    a = JaxEngine(**kw)
    a.run(verbose=False)

    # run half with checkpointing, then resume in a FRESH engine
    b = JaxEngine(**kw)
    b.run(nt=24, verbose=False, chunk=12, checkpoint_every=2,
          checkpoint_path=ck)
    assert ck.exists()
    c = JaxEngine(**kw)
    c.run(verbose=False, chunk=12, checkpoint_path=ck, resume=True)
    assert np.array_equal(a.u_out, c.u_out)


def test_cli_sim_and_process(tmp_path):
    from pffdtd_jax.cli import main

    sim = _sim()
    save_sim_data(sim, tmp_path)
    main(["sim", "--data_dir", str(tmp_path), "--f64", "--energy"])
    assert (tmp_path / "sim_outs.h5").exists()
    main(["process", "--data_dir", str(tmp_path), "--fcut_lowpass", "800",
          "--symmetric_lowpass", "--air_abs_filter", "ola", "--save_wav",
          "--plot"])
    assert (tmp_path / "sim_outs_processed.h5").exists()
    assert (tmp_path / "R001_out_normalised.wav").exists()
    assert (tmp_path / "rirs.png").stat().st_size > 1000


def test_cli_numpy_engine(tmp_path):
    from pffdtd_jax.cli import main

    sim = _sim()
    save_sim_data(sim, tmp_path)
    main(["sim", "--data_dir", str(tmp_path), "--engine", "numpy"])
    assert (tmp_path / "sim_outs.h5").exists()


def test_cli_fit_material(tmp_path):
    from pffdtd_jax.cli import main
    from pffdtd_jax.io.h5 import read_mat_file

    out = tmp_path / "mat.h5"
    main(["fit-material", "--out", str(out),
          "--sabs", ".1,.1,.2,.3,.4,.5,.5,.5,.5,.4,.4"])
    DEF = read_mat_file(out)
    assert DEF.shape == (11, 3)


def test_cli_f64_matches_oracle(tmp_path):
    """--f64 must switch JAX to 64-bit itself: with x64 off beforehand, an
    fp64 run would otherwise compute in fp32 (~1e-6 off the oracle)."""
    import jax

    from pffdtd_jax.cli import main
    from pffdtd_jax.engine.numpy_ref import NumpyEngine
    from pffdtd_jax.io.h5 import read_outputs

    sim = _sim()
    save_sim_data(sim, tmp_path)
    jax.config.update("jax_enable_x64", False)
    try:
        eng = main(["sim", "--data_dir", str(tmp_path), "--f64"])
        assert jax.config.jax_enable_x64
    finally:
        jax.config.update("jax_enable_x64", True)
    assert eng.data.dtype == np.float64
    ref = NumpyEngine(tmp_path)
    ref.run_all()
    u = read_outputs(tmp_path)
    scale = np.abs(ref.u_out).max()
    assert scale > 0
    assert np.abs(u - ref.u_out[ref.comms.out_reorder]).max() / scale < 1e-12
