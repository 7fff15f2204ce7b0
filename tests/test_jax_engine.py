"""JAX engine vs the NumPy oracle: outputs to machine accuracy in fp64,
padding invariance, fp32 path sanity (the reference's own cross-engine
criterion, README.md:60)."""

import numpy as np
import pytest

import jax

from pffdtd_jax.engine.jax_engine import JaxEngine
from pffdtd_jax.engine.numpy_ref import NumpyEngine

import scenes

# odd_nx also runs an odd step count: the scan pads the last pair
ORACLE_NT = {"odd_nx": 47}


def _oracle(sim, nt=None):
    o = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats)
    nt = nt or o.Nt
    o.run_steps(nt)
    return o.u_out[:, :nt]


def _jax(sim, nt=None, **kw):
    kw.setdefault("dtype", np.float64)
    j = JaxEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                  mats=sim.mats, **kw)
    return j.run(nt=nt, verbose=False)


def _assert_close(u, ref, tol=1e-12):
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(u - ref).max() / scale
    assert err < tol, f"max rel err {err:.3e}"


@pytest.mark.parametrize("rigid", ["dense", "sparse"])
@pytest.mark.parametrize("scene", list(scenes.SCENES))
def test_matches_oracle(scene, rigid):
    sim = scenes.make(scene)
    nt = ORACLE_NT.get(scene)
    u = _jax(sim, nt=nt, rigid=rigid)
    ref = _oracle(sim, nt)
    assert u.shape == ref.shape
    _assert_close(u, ref)


@pytest.mark.parametrize("rigid", ["dense", "sparse"])
@pytest.mark.parametrize("scene", ["cart_lossy", "folded_lossy"])
def test_padding_invariance(scene, rigid):
    """z-padding the grid must not change results at all."""
    sim = scenes.make(scene)
    u1 = _jax(sim, rigid=rigid)
    u2 = _jax(sim, rigid=rigid, pad_z=32)
    assert np.array_equal(u1, u2)


def test_fp32_runs_and_tracks_fp64():
    sim = scenes.shoebox_sim(lossy=True, sig="hann20", duration=0.03)
    ref = _oracle(sim)
    u = _jax(sim, dtype=np.float32)
    assert np.isfinite(u).all()
    # fp32 rounding accumulation
    _assert_close(u, ref, tol=1e-3)


def test_float64_requires_x64():
    sim = scenes.shoebox_sim()
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="jax_enable_x64"):
            _jax(sim, dtype=np.float64)
    finally:
        jax.config.update("jax_enable_x64", True)


def test_rejects_unknown_rigid_mode():
    with pytest.raises(ValueError, match="rigid"):
        _jax(scenes.shoebox_sim(), rigid="pallas")


@pytest.mark.parametrize("rigid", ["dense", "sparse"])
def test_fp32_eps_shift_matches_oracle(rigid):
    """The fp32 diagonal shift is a scheme change the oracle reproduces:
    in fp64 both run (1+EPS)*K on every node's degree."""
    from pffdtd_jax.engine.coeffs import FP32_EPS

    sim = scenes.make("cart_lossy")
    o = NumpyEngine(consts=sim.consts, vox=sim.vox, comms=sim.comms,
                    mats=sim.mats, fp32_eps=1e3 * FP32_EPS)
    o.run_all()
    u = _jax(sim, rigid=rigid, fp32_eps=1e3 * FP32_EPS)
    _assert_close(u, o.u_out)
    assert np.abs(u - _oracle(sim)).max() > 1e-9 * np.abs(u).max()
