"""Materials fitting + air absorption + post-processing tests."""

import numpy as np
import pytest

from pffdtd_jax.materials import (compute_Rf_from_DEF, convert_R_to_Yn,
                                  convert_Sabs_to_Yn, convert_Yn_to_R,
                                  fit_to_Sabs_oct_11, from_DEF, to_DEF)
from pffdtd_jax.analysis.air_abs import (air_absorption, apply_modal_filter,
                                         apply_ola_filter, apply_visco_filter)


def test_conversions_roundtrip():
    Yn = 0.3
    R = convert_Yn_to_R(Yn)
    assert np.isclose(convert_R_to_Yn(R), Yn)
    D, E, F = to_DEF(0.25, 100.0, 2000.0)
    Ynm, dw, w0 = from_DEF(D, E, F)
    assert np.allclose([Ynm, dw, w0], [0.25, 100.0, 2000.0])


def test_paris_inversion():
    # Paris formula: a(g) = 8g(1 + g/(1+g) - 2g ln((g+1)/g)); Newton inverse
    for Sabs in (0.1, 0.3, 0.6, 0.9):
        g = convert_Sabs_to_Yn(Sabs)
        a = 8 * g * (1 + g / (1 + g) - 2 * g * np.log((g + 1) / g))
        assert abs(a - Sabs) < 1e-5
    assert convert_Sabs_to_Yn(0.0) == 0.0


def test_fit_to_sabs():
    Sabs = np.array([.1, .15, .2, .3, .4, .5, .55, .6, .6, .55, .5])
    DEF = fit_to_Sabs_oct_11(Sabs)
    assert DEF.shape == (11, 3)
    assert np.all(DEF > 0)
    # achieved absorption at the octave centres within a loose band
    fcv = 1000 * 2.0 ** np.arange(-6, 5)
    jw = 1j * 2 * np.pi * fcv
    Rf, Yn, _, _ = compute_Rf_from_DEF(jw, *DEF.T)
    ach = 1 - np.abs(Rf) ** 2
    assert np.max(np.abs(ach - Sabs)) < 0.15


def test_air_absorption_curves():
    f = np.array([125.0, 1000.0, 4000.0, 16000.0])
    rd = air_absorption(f, 20.0, 50.0)
    # attenuation increases with frequency; sane magnitudes (dB/m)
    assert np.all(np.diff(rd["absfull_dB"]) > 0)
    assert 1e-4 < rd["absfull_dB"][1] < 0.02     # ~5 dB/km at 1 kHz
    assert 0.01 < rd["absfull_dB"][3] < 0.5      # tens of dB per 100 m at 16k
    # classical + vibrational decomposition consistent
    total = rd["absClRo_dB"] + rd["absVibO_dB"] + rd["absVibN_dB"]
    assert np.allclose(total, rd["absfull_dB"])


def _burst(Fs=48000, T=0.25, seed=0):
    rng = np.random.default_rng(seed)
    n = int(T * Fs)
    t = np.arange(n) / Fs
    return (rng.standard_normal(n) * np.exp(-t / 0.05)).astype(np.float64)


@pytest.mark.parametrize("apply", [apply_visco_filter, apply_ola_filter])
def test_air_filters_attenuate_hf(apply):
    Fs = 48000.0
    x = _burst(Fs)
    y = np.atleast_1d(apply(x, Fs, Tc=20.0, rh=50.0))
    # energy is reduced, mostly at high frequencies late in the tail
    X = np.abs(np.fft.rfft(x[-2048:]))
    Y = np.abs(np.fft.rfft(y[len(x) - 2048:len(x)]))
    f = np.fft.rfftfreq(2048, 1 / Fs)
    hf = f > 10e3
    lf = (f > 50) & (f < 500)
    assert Y[hf].sum() < 0.8 * X[hf].sum()
    assert Y[lf].sum() > 0.5 * X[lf].sum()


def test_modal_filter_jax_matches_numpy():
    Fs = 8000.0
    x = _burst(Fs, T=0.05)
    yj = apply_modal_filter(x, Fs, Tc=20.0, rh=50.0, use_jax=True)
    yn = apply_modal_filter(x, Fs, Tc=20.0, rh=50.0, use_jax=False)
    assert np.allclose(yj, yn, atol=1e-10)
    # attenuates but preserves the overall shape
    assert 0.2 < np.linalg.norm(yn) / np.linalg.norm(x) <= 1.01
