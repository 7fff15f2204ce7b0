"""Small shared helpers (index math, rotations, wav IO).

Functional parity targets: reference python/common/myfuncs.py
(ind2sub3d:158-162, rel_diff:164-165, rotation matrices:31-82, wav IO:261-271).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_CACHE_DONE = False
_REPO_ROOT = Path(__file__).resolve().parents[2]


def compilation_cache_dir() -> str | None:
    """The directory this program points JAX's persistent compile cache at:
    None when JAX_COMPILATION_CACHE_DIR is set (JAX reads that variable
    itself), otherwise a fixed `.jax_cache/` in the checkout — the path is
    part of the cache key, so it must not move between runs."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(_REPO_ROOT / ".jax_cache")


def enable_compilation_cache():
    """Turn on JAX's persistent compilation cache (once per process).

    Compiling the engine's scan at bench scale takes tens of seconds; the
    cache lets later processes on the same machine skip it.  Called by
    every engine constructor.  Leaves the CPU backend alone: CPU entries
    are specific to the host's instruction set.
    """
    global _CACHE_DONE
    if _CACHE_DONE:
        return
    _CACHE_DONE = True
    d = compilation_cache_dir()
    if d is None:
        return
    import jax

    if jax.devices()[0].platform == "cpu":
        return
    os.makedirs(d, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", d)
    # cache every nontrivial compile (default threshold is 1 s wall)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def iceil(x) -> np.int_:
    return np.int_(np.ceil(x))


def iround(x) -> np.int_:
    return np.int_(np.round(x))


def ind2sub3d(ii, Nx, Ny, Nz):
    """Linear index -> (ix, iy, iz) with z contiguous (row-major x,y,z)."""
    ii = np.asarray(ii)
    iz = ii % Nz
    iy = (ii // Nz) % Ny
    ix = ii // (Ny * Nz)
    return ix, iy, iz


def sub2ind3d(ix, iy, iz, Nx, Ny, Nz):
    """(ix, iy, iz) -> linear index with z contiguous."""
    return (np.asarray(ix) * Ny + np.asarray(iy)) * Nz + np.asarray(iz)


def rel_diff(x0, x1):
    """Difference normalised to the binary exponent of x0 (machine-eps units).

    Zero entries of x0 (e.g. the first step's E_in before any input energy)
    normalise by 2^0, i.e. degrade to the raw difference instead of inf/nan.
    """
    ax = np.abs(np.asarray(x0, np.float64))
    expo = np.where(ax > 0, np.floor(np.log2(np.where(ax > 0, ax, 1.0))), 0.0)
    return (x0 - x1) / (2.0 ** expo)


def dotv(v1, v2):
    """Row-wise dot product over the last axis."""
    return np.sum(v1 * v2, axis=-1)


def vecnorm(v):
    return np.sqrt(dotv(v, v))


def normalise(v, eps=np.finfo(np.float64).eps):
    return (np.asarray(v).T / (vecnorm(v) + eps)).T


def rotate_xyz_deg(thx_d, thy_d, thz_d):
    """Rotation matrix applying Rz, then Ry, then Rx (right-hand rule)."""
    thx, thy, thz = np.deg2rad([thx_d, thy_d, thz_d])
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(thx), -np.sin(thx)],
                   [0, np.sin(thx), np.cos(thx)]])
    Ry = np.array([[np.cos(thy), 0, np.sin(thy)],
                   [0, 1, 0],
                   [-np.sin(thy), 0, np.cos(thy)]])
    Rz = np.array([[np.cos(thz), -np.sin(thz), 0],
                   [np.sin(thz), np.cos(thz), 0],
                   [0, 0, 1]])
    return Rx @ Ry @ Rz, Rx, Ry, Rz


def rotate_az_el_deg(az_d, el_d):
    """Azimuth (about z) after elevation (about -y); matlab-style convention."""
    _, _, Ry, Rz = rotate_xyz_deg(0.0, -el_d, az_d)
    return Rz @ Ry, Rz, Ry


def wavwrite(fname, sr: int, data):
    """Write float32 WAV; data is (Nchannels, Nsamples) or (Nsamples,)."""
    import scipy.io.wavfile

    data = np.atleast_2d(data)
    scipy.io.wavfile.write(fname, int(sr), np.float32(data.T))


def wavread(fname):
    import scipy.io.wavfile

    sr, data = scipy.io.wavfile.read(fname)
    if data.dtype == np.int16:
        data = data / 32768.0
    return float(sr), np.float64(data.T)


class TimerDict:
    """tic/toc named timers (reference: python/common/timerdict.py:19-57).

    >>> t = TimerDict(); t.tic("vox"); ...; print(t.ftoc("vox"))
    Un-toc'd timers are reported on deletion so leaks are visible.
    """

    def __init__(self):
        import time as _time

        self._time = _time
        self._start = {}

    def tic(self, key):
        self._start[key] = self._time.perf_counter()

    def toc(self, key, print_elapsed=False):
        dt = self._time.perf_counter() - self._start.pop(key)
        if print_elapsed:
            print(f"--TIMER: {key} took {dt:.3f}s", flush=True)
        return dt

    def ftoc(self, key):
        return f"{key} took {self.toc(key):.3f}s"

    def __del__(self):
        for key in self._start:
            print(f"--TIMER WARNING: timer '{key}' never toc'd")
