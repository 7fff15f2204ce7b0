"""chip_smoke.py: refuses to run without a GPU, and its phases and
comparison helpers work at a tiny size on the CPU.  The full run is the
`gpu`-marked test (python -m pytest tests -m gpu on a GPU machine)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parents[1]


def _run(cwd, env_extra, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_ENABLE_X64")}
    env.update(env_extra)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_gpu(where, tmp_path):
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    r = _run(cwd, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_oracle_and_fp64_phases_on_cpu(tmp_path):
    eng, err, err_unshifted = cs.phase_oracle(tmp_path)
    assert err <= cs.ORACLE_TOL
    assert err_unshifted < 1e-3
    assert eng.data.dtype == np.float32
    assert (tmp_path / "sim_outs_processed.h5").exists()
    eng, bal, err = cs.phase_fp64(tmp_path)
    assert bal < cs.ENERGY_F64_TOL
    assert err < 1e-12


@pytest.mark.parametrize("u,ok", [
    (np.ones((2, 4)), True),
    (np.zeros((2, 4)), False),
    (np.array([[0.0, np.nan]]), False),
    (np.array([[0.0, np.inf]]), False),
])
def test_check_trace(u, ok):
    if ok:
        cs.check_trace(u, "t")
    else:
        with pytest.raises(AssertionError):
            cs.check_trace(u, "t")


def test_rel_err_and_rates():
    ref = np.array([[0.0, 2.0, -4.0]])
    assert cs.rel_err(ref + [[0.0, 0.0, 0.4]], ref) == pytest.approx(0.1)
    with pytest.raises(AssertionError):
        cs.rel_err(ref[:, :2], ref)
    with pytest.raises(AssertionError):
        cs.rel_err(ref, np.zeros_like(ref))
    assert cs.bytes_per_voxel(True) == 14 and cs.bytes_per_voxel(False) == 13
    # 1e9 voxels x 10 steps x 14 B in 1 s = 140 GB/s
    assert cs.effective_gbps(10**9, 10, 1.0, True) == pytest.approx(140.0)


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    r = _run(ROOT, {}, timeout=1500)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
