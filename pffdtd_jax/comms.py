"""Sources/receivers: trilinear interpolation weights and input signals.

Semantics parity target: reference python/fdtd/sim_comms.py:57-249:
8-point trilinear injection/readout (FCC variant uses doubled offsets on the
even-parity subgrid with a parity snap); signal types impulse / hann10 /
hann20 / dhann30 / hann5ms; grid scaling in_sigs *= l2/h (x0.5 for FCC);
`diff_source` bilinear-transform differentiator (the fp32 DC safeguard); and
the source/receiver vs boundary clash check.
"""

from __future__ import annotations

import numpy as np
from numpy import cos, pi, sin

from pffdtd_jax.utils import iceil, sub2ind3d

_OFF8 = np.array([[0, 0, 0], [-1, 0, 0], [0, -1, 0], [0, 0, -1],
                  [-1, -1, 0], [-1, 0, -1], [0, -1, -1], [-1, -1, -1]],
                 np.int64)


def linear_interp_weights(pos_xyz, xv, yv, zv, h, fcc=False):
    """8-point trilinear weights/indices for one position.

    Returns (alpha8, ixyz8): weights summing to 1 and linear grid indices.
    On the FCC subgrid the cell is the doubled-spacing cube of even-parity
    points; the anchor is snapped to even parity along the axis with the
    smallest fractional offset.
    """
    pos_xyz = np.asarray(pos_xyz, np.float64)
    vlist = [np.asarray(xv), np.asarray(yv), np.asarray(zv)]
    Nx, Ny, Nz = (v.size for v in vlist)

    anchor = np.empty(3, np.int64)
    alpha = np.zeros(3)
    for j in range(3):
        anchor[j] = np.flatnonzero(vlist[j] >= pos_xyz[j])[0]
        alpha[j] = (vlist[j][anchor[j]] - pos_xyz[j]) / h

    off8 = _OFF8.copy()
    if fcc:
        off8 *= 2
        if anchor.sum() % 2 == 1:
            anchor[np.argmin(alpha)] += 1
        for j in range(3):
            alpha[j] = (vlist[j][anchor[j]] - pos_xyz[j]) / (2 * h)

    alpha8 = np.ones(8)
    for i in range(8):
        for j in range(3):
            alpha8[i] *= alpha[j] if off8[i, j] != 0 else (1 - alpha[j])

    ixyz8 = anchor + off8
    assert np.allclose(alpha8.sum(), 1.0)
    # weights reproduce the position exactly
    pos8 = np.stack([vlist[j][ixyz8[:, j]] for j in range(3)], -1)
    assert np.allclose(alpha8 @ pos8, pos_xyz)
    if fcc:
        assert np.all(ixyz8.sum(-1) % 2 == 0)

    lin8 = sub2ind3d(ixyz8[:, 0], ixyz8[:, 1], ixyz8[:, 2], Nx, Ny, Nz)
    return alpha8, lin8


def make_source_signal(sig_type: str, Nt: int, Ts: float) -> np.ndarray:
    """Canonical input signals (sim_comms.py:63-91)."""
    sig = np.zeros(Nt)
    if sig_type == "impulse":
        sig[0] = 1.0
    elif sig_type in ("hann10", "hann20"):
        N = int(sig_type[4:])
        n = np.arange(N)
        full = 0.5 * (1.0 - cos(2 * pi * n / N))
        sig[:N] = full[:Nt]
    elif sig_type == "dhann30":
        N = 30
        n = np.arange(N)
        full = cos(pi * n / N) * sin(pi * n / N)
        sig[:N] = full[:Nt]
    elif sig_type == "hann5ms":
        N = iceil(5e-3 / Ts)
        n = np.arange(N)
        full = 0.5 * (1.0 - cos(2 * pi * n / N))
        sig[:N] = full[:Nt]
    else:
        raise ValueError(f"unknown sig_type {sig_type!r}")
    return sig


def diff_signal(in_sigs: np.ndarray, Ts: float) -> np.ndarray:
    """Bilinear-transform differentiator: y[n] = 2/Ts (x[n]-x[n-1]) - y[n-1].

    Mandatory for single-precision runs (DC-mode safeguard); undone in
    post-processing by the matching integrator.
    """
    from scipy.signal import lfilter

    b = 2.0 / Ts * np.array([1.0, -1.0])
    a = np.array([1.0, 1.0])
    return lfilter(b, a, in_sigs, axis=-1)


class SimComms:
    """Prepare and save source/receiver data for a sim folder."""

    def __init__(self, xv, yv, zv, h, Ts, l2, fcc=False):
        self.xv, self.yv, self.zv = xv, yv, zv
        self.h, self.Ts, self.l2, self.fcc = h, Ts, l2, fcc
        self._diff = False

    @classmethod
    def from_folder(cls, folder):
        from pffdtd_jax.io.h5 import read_cart_grid, read_consts

        c = read_consts(folder)
        xv, yv, zv, h = read_cart_grid(folder)
        return cls(xv, yv, zv, h, c.Ts, c.l2, fcc=c.fcc)

    def prepare_source_pts(self, Sxyz):
        self.in_alpha, self.in_ixyz = linear_interp_weights(
            Sxyz, self.xv, self.yv, self.zv, self.h, self.fcc)

    def prepare_receiver_pts(self, Rxyz):
        Rxyz = np.atleast_2d(Rxyz)
        Nr = Rxyz.shape[0]
        self.out_alpha = np.zeros((Nr, 8))
        self.out_ixyz = np.zeros((Nr, 8), np.int64)
        for r in range(Nr):
            self.out_alpha[r], self.out_ixyz[r] = linear_interp_weights(
                Rxyz[r], self.xv, self.yv, self.zv, self.h, self.fcc)

    def prepare_source_signals(self, duration, sig_type="impulse"):
        Nt = iceil(duration / self.Ts)
        sig = make_source_signal(sig_type, Nt, self.Ts)
        in_sigs = self.in_alpha[:, None] * sig[None, :]
        # grid scaling: c^2 Ts^2 / cell-volume
        in_sigs *= (0.5 * self.l2 / self.h) if self.fcc else (self.l2 / self.h)
        self.in_sigs = in_sigs

    def diff_source(self):
        if not self._diff:
            self.in_sigs = diff_signal(self.in_sigs, self.Ts)
            self._diff = True

    def to_comms_data(self):
        from pffdtd_jax.io.h5 import CommsData

        out_ixyz = self.out_ixyz.reshape(-1)
        return CommsData(
            in_ixyz=self.in_ixyz,
            out_ixyz=out_ixyz,
            out_alpha=self.out_alpha,
            out_reorder=np.arange(out_ixyz.size),
            in_sigs=self.in_sigs,
            diff=self._diff,
        )

    def save(self, save_folder, compress=None):
        from pffdtd_jax.io.h5 import write_comms

        write_comms(save_folder, self.to_comms_data(), compress=compress)

    def check_for_clashes(self, bn_ixyz):
        """Sources/receivers must not sit on boundary nodes (scheme assumption)."""
        for name, ixyz in (("in", self.in_ixyz), ("out", self.out_ixyz)):
            u = np.unique(ixyz)
            if np.intersect1d(u, bn_ixyz).size:
                raise AssertionError(f"{name}_ixyz intersects boundary nodes")
