"""Cross-validation against the ACTUAL reference Python engine.

The reference's own acceptance criterion is cross-ENGINE sample equality
(README.md:60: engines "produce identical results (to within machine
accuracy)"; print_last_samples, sim_fdtd.py:660-669).  This test runs the
reference engine (/root/reference/python/fdtd/sim_fdtd.py) UNMODIFIED on a
sim folder produced by THIS framework's setup pipeline and diffs u_out
against our engines at machine accuracy.

numba is not installed in this environment; the reference's @nb.jit kernels
are plain Python under a no-op shim (njit/jit = identity, prange = range),
which executes the exact same statements, just slowly — hence the tiny grid.
Skipped when the reference mount is absent.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

REF_PY = Path("/root/reference/python")

pytestmark = pytest.mark.skipif(not REF_PY.exists(),
                                reason="reference mount not available")


def _install_numba_shim():
    if "numba" in sys.modules:
        return
    nb = types.ModuleType("numba")

    def _jit(*args, **kw):
        if args and callable(args[0]):  # bare @nb.jit
            return args[0]

        def deco(fn):
            return fn

        return deco

    nb.jit = _jit
    nb.njit = _jit
    nb.prange = range
    nb.set_num_threads = lambda n: None
    nb.get_num_threads = lambda: 1
    sys.modules["numba"] = nb


@pytest.fixture(scope="module")
def ref_engine_mod():
    _install_numba_shim()
    # the reference targets numpy<1.24: restore the removed scalar aliases
    for alias, repl in (("float", float), ("float_", np.float64)):
        if alias not in np.__dict__:
            setattr(np, alias, repl)
    sys.path.insert(0, str(REF_PY))
    try:
        from fdtd import sim_fdtd
    finally:
        sys.path.remove(str(REF_PY))
    return sim_fdtd


def _make_folder(tmp_path, lossy):
    from conftest import make_shoebox
    from pffdtd_jax.scene_setup import (mats_from_DEF_list,
                                        sim_setup_from_room)

    DEF = [np.array([[2.0, 5.0, 30.0], [1.0, 10.0, 300.0]])]
    if lossy:
        rg = make_shoebox(1.6, 1.3, 1.1, mats=["walls"] * 6)
        mats = mats_from_DEF_list(DEF)
    else:
        rg = make_shoebox(1.6, 1.3, 1.1)
        mats = None
    sim = sim_setup_from_room(rg, mats, duration=6e-3, insig_type="hann10",
                              h=0.18, save_folder=tmp_path)
    return sim


def _run_reference(sim_fdtd, folder):
    eng = sim_fdtd.SimEngine(folder, energy_on=True, nthreads=1)
    eng.load_h5_data()
    eng.setup_mask()
    eng.allocate_mem()
    eng.set_coeffs()
    eng.checks()
    # nsteps=1 (the reference default): its energy bookkeeping reads
    # self.u0/self.Lu1 which are only rebound at block boundaries, so
    # multi-step blocks would alternate stale buffers (sim_fdtd.py:587-589)
    eng.run_all(nsteps=1)
    return eng


@pytest.mark.parametrize("lossy", [False, True])
def test_reference_engine_sample_equality(tmp_path, ref_engine_mod, lossy):
    sim = _make_folder(tmp_path, lossy)
    ref = _run_reference(ref_engine_mod, tmp_path)

    # the reference engine's energy oracle must hold on OUR sim folder: this
    # validates the whole setup pipeline (voxelizer, SAF, comms, materials)
    # against physics, independent of our engines
    from pffdtd_jax.utils import rel_diff

    n = ref.Nt
    live = ref.E_in[:n] > 0
    bal = rel_diff(ref.H_tot[:n][live] + ref.E_lost[:n][live],
                   ref.E_in[:n][live])
    assert np.abs(bal).max() < 1e-10

    # our oracle engine vs the reference engine: machine accuracy
    from pffdtd_jax.engine.numpy_ref import NumpyEngine

    mine = NumpyEngine(tmp_path)
    mine.run_all()
    scale = np.abs(ref.u_out).max()
    assert np.abs(mine.u_out - ref.u_out).max() <= 1e-13 * scale

    # the jitted engine too (fp64 on the CPU test platform)
    from pffdtd_jax.engine.jax_engine import JaxEngine

    je = JaxEngine(tmp_path, dtype=np.float64)
    je.run(verbose=False)
    assert np.abs(je.u_out - ref.u_out).max() <= 1e-12 * scale
