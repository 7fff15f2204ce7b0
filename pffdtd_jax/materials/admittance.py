"""Wall admittance (material) tools: conversions, fitting, DEF files.

Physics parity target: reference python/materials/adm_funcs.py:
- passive impedance model: per-branch specific impedance Z_m(jw) = jw*D_m +
  E_m + F_m/jw; admittance Y(jw) = sum_m 1/Z_m (adm_funcs.py:219-224);
- Sabine absorption -> specific admittance via Paris-formula inversion with
  a Newton solve (50-72);
- `fit_to_Sabs_oct_11`: fit 11 resonant branches (octave centres 16 Hz to
  16 kHz, half-octave bandwidths) to 11 octave-band absorption coefficients
  by Nelder-Mead over the branch peak admittances (243-322).

DEF triplets are written one material per HDF5 file (dataset 'DEF', (Mb,3)).
"""

from __future__ import annotations

import numpy as np
from numpy import log10, pi, sqrt


def convert_nabs_to_R(nabs):
    """Normal-incidence absorption -> reflection coefficient magnitude."""
    nabs = np.float64(nabs)
    assert 0 <= nabs <= 1
    return np.sqrt(1.0 - nabs)


def convert_Yn_to_R(Yn):
    assert np.all(Yn > 0)
    return (1.0 - Yn) / (1.0 + Yn)


def convert_R_to_Yn(R):
    assert np.all(R < 1.0)
    return (1.0 - R) / (1.0 + R)


def convert_R_to_Zn(R):
    return 1.0 / convert_R_to_Yn(R)


def convert_Sabs_to_Yn(Sabs, max_iter=100):
    """Sabine (random-incidence) absorption -> specific admittance.

    Inverts the Paris formula a(g) = 8g(1 + g/(1+g) - 2g ln((g+1)/g)) by
    Newton iteration; Sabs > 0.9512 is unreachable for locally-reactive
    surfaces and is clamped.
    """
    if Sabs > 0.9512:
        Sabs = 0.9512
    fg = lambda g: 8.0 * g * (1 + g / (1 + g) - 2 * g * np.log((g + 1) / g))
    fgd = lambda g: -8.0 * (-4 * g ** 2 - 6 * g
                            + 4 * (1 + g) ** 2 * g * np.log((g + 1) / g)
                            - 1) / (1 + g) ** 2
    if Sabs == 0:
        return 0.0
    x_old = Sabs / 8.0
    for _ in range(max_iter):
        x_new = x_old - (fg(x_old) - Sabs) / fgd(x_old)
        if abs(1 - x_new / x_old) <= 1e-6:
            x_old = x_new
            break
        x_old = x_new
    return float(x_old)


def compute_Rf_from_DEF(jw, D, E, F):
    """Reflection coefficient / admittance spectra from DEF branch triplets."""
    Zn_br = jw[:, None] * D[None, :] + E + F[None, :] / jw[:, None]
    Yn = np.sum(1.0 / Zn_br, axis=-1)
    Rf = (1.0 - Yn) / (1.0 + Yn)
    Rf_br = (Zn_br - 1.0) / (Zn_br + 1.0)
    return Rf, Yn, Zn_br, Rf_br


def to_DEF(Ynm, dw, w0):
    """(peak admittance, half-power bandwidth, resonance) -> DEF triplet."""
    D = 1.0 / Ynm / dw
    E = 1.0 / Ynm
    F = w0 ** 2 / Ynm / dw
    return D, E, F


def from_DEF(D, E, F):
    Ynm = 1.0 / E
    dw = E / D
    w0 = np.sqrt(F / D)
    return Ynm, dw, w0


def write_freq_ind_mat_from_Zn(Zn, filename):
    """Frequency-independent material: DEF = (0, Zn, 0)."""
    from pffdtd_jax.io.h5 import H5File

    assert np.isfinite(Zn) and Zn >= 0
    with H5File(filename, "w") as f:
        f.create_dataset("DEF", data=np.atleast_2d([0.0, float(Zn), 0.0]))


def write_freq_ind_mat_from_Yn(Yn, filename):
    assert np.isfinite(Yn) and Yn > 0
    write_freq_ind_mat_from_Zn(1.0 / Yn, filename)


def write_freq_dep_mat(DEF, filename):
    from pffdtd_jax.io.h5 import H5File

    DEF = np.atleast_2d(np.asarray(DEF, np.float64))
    assert np.all(np.isfinite(DEF)) and np.all(DEF >= 0)
    assert np.all(np.sum(DEF > 0, axis=-1) > 0)
    assert DEF.shape[1] == 3
    with H5File(filename, "w") as f:
        f.create_dataset("DEF", data=DEF)


def fit_to_Sabs_oct_11(Sabs, filename=None, fv=None):
    """Fit 11 RLC branches to 11 octave-band absorption coefficients.

    Sabs: absorption at octave centres 1000*2^-6..1000*2^4 Hz (16 Hz-16 kHz).
    Returns the (11, 3) DEF array; writes it to `filename` if given.
    """
    import scipy.optimize as scpo

    Sabs = np.asarray(Sabs, np.float64)
    assert Sabs.size == 11
    Noct = Sabs.size
    if fv is None:
        fv = np.logspace(log10(10), log10(20e3), 1000)
    jw = 1j * fv * 2 * pi
    fcv = 1000 * (2.0 ** np.arange(-6, 5))
    ymv = np.zeros(Noct)
    dwv = np.zeros(Noct)
    w0v = np.zeros(Noct)
    Y_target = np.zeros(fv.shape)
    for j in range(Noct):
        fc = fcv[j]
        Ynm = convert_Sabs_to_Yn(Sabs[j])
        i1 = 0 if j == 0 else np.flatnonzero(fv >= fc / sqrt(2))[0]
        i2 = fv.size if j == Noct - 1 else np.flatnonzero(fv >= fc * sqrt(2))[0]
        Y_target[i1:i2] = Ynm
        w0v[j] = 2 * pi * fc
        dwv[j] = w0v[j] / sqrt(2)  # half-octave bandwidth
        ymv[j] = Ynm

    R_target = (1.0 - Y_target) / (1.0 + Y_target)
    abs_target = 1 - np.abs(R_target) ** 2

    def cost(ym):
        if np.any(ym < 0):
            return np.finfo(np.float64).max
        D, E, F = to_DEF(ym, dwv, w0v)
        Rf, _, _, _ = compute_Rf_from_DEF(jw, D, E, F)
        return np.sum(np.abs((1 - np.abs(Rf) ** 2) - abs_target))

    initial = cost(ymv)
    res = scpo.minimize(cost, ymv, method="Nelder-Mead")
    assert cost(res.x) <= initial
    D, E, F = to_DEF(res.x, dwv, w0v)
    DEF = np.c_[D, E, F]
    if filename is not None:
        write_freq_dep_mat(DEF, filename)
    return DEF
