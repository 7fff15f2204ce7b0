"""Update coefficients: scheme constants and material (RLC branch) transforms.

Numerics parity targets:
- scheme coefficients a1/a2/sl2 with the single-precision EPS safeguard:
  reference c_cuda/fdtd_data.h:186-199 — dsl2 = (1+EPS)*lfac*l2,
  a1 = 2 - dsl2*K, a2 = lfac*l2, where lfac = 0.25 (FCC) or 1 (Cartesian) and
  K = 12 or 6.  In double precision EPS = 0; in single the (1+EPS) diagonal
  shift keeps the discrete Laplacian negative semi-definite under rounding
  (reference additionally uses round-toward-zero for off-diagonal adds, a CUDA
  intrinsic with no XLA equivalent; the EPS shift is the load-bearing part and
  is made configurable here).
- material branch transform DEF -> (b, bd, bDh, bFh, beta):
  reference c_cuda/fdtd_data.h:434-457 and
  reference python/fdtd/sim_fdtd.py:240-259 (the [BHBS16] ISMRA-2016
  frequency-dependent impedance update): Dh = D/Ts, Eh = E, Fh = F*Ts,
  b = 1/(2Dh + Eh + Fh/2), bd = b*(2Dh - Eh - Fh/2), beta = sum_m b_m.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pffdtd_jax.io.h5 import MMb, MatsData

FP32_EPS = 1.19209289e-07  # fdtd_common.h:67


@dataclass
class SchemeCoeffs:
    l: float
    l2: float
    lfac: float   # Laplacian prefactor: 0.25 FCC, 1 Cartesian
    K: int        # full neighbour count: 12 FCC, 6 Cartesian
    a1: float     # 2 - sl2*K (diagonal, with EPS shift in fp32)
    a2: float     # lfac*l2 (off-diagonal)
    sl2: float    # (1+EPS)*lfac*l2
    lo2: float    # l/2

    @classmethod
    def make(cls, l: float, l2: float, fcc: bool, eps: float = 0.0) -> "SchemeCoeffs":
        lfac = 0.25 if fcc else 1.0
        K = 12 if fcc else 6
        sl2 = (1.0 + eps) * lfac * l2
        return cls(l=l, l2=l2, lfac=lfac, K=K,
                   a1=2.0 - sl2 * K, a2=lfac * l2, sl2=sl2, lo2=0.5 * l)


@dataclass
class MatCoeffs:
    """Per-material branch coefficients, zero-padded to MMb branches.

    All arrays are (Nmat+1, MMb); index Nmat is the implicit rigid material
    (all-zero coefficients) so a gather with mat index -1 -> Nmat is safe.
    """

    b: np.ndarray
    bd: np.ndarray
    bDh: np.ndarray
    bFh: np.ndarray
    beta: np.ndarray  # (Nmat+1,)
    D: np.ndarray     # raw DEF (for energy accounting)
    E: np.ndarray
    F: np.ndarray

    @classmethod
    def from_mats(cls, mats: MatsData, Ts: float) -> "MatCoeffs":
        Nm = mats.Nmat
        shape = (Nm + 1, MMb)
        b = np.zeros(shape)
        bd = np.zeros(shape)
        bDh = np.zeros(shape)
        bFh = np.zeros(shape)
        D = np.zeros(shape)
        E = np.zeros(shape)
        F = np.zeros(shape)
        for k in range(Nm):
            M = int(mats.Mb[k])
            Dk, Ek, Fk = mats.DEF[k, :M].T
            Dh, Eh, Fh = Dk / Ts, Ek, Fk * Ts
            bk = 1.0 / (2.0 * Dh + Eh + 0.5 * Fh)
            dk = 2.0 * Dh - Eh - 0.5 * Fh
            assert np.all(np.isfinite(bk)) and np.all(np.isfinite(dk))
            b[k, :M] = bk
            bd[k, :M] = bk * dk
            bDh[k, :M] = bk * Dh
            bFh[k, :M] = bk * Fh
            D[k, :M], E[k, :M], F[k, :M] = Dk, Ek, Fk
        beta = b.sum(-1)
        assert np.all(beta >= 0)
        return cls(b=b, bd=bd, bDh=bDh, bFh=bFh, beta=beta, D=D, E=E, F=F)

    def gather(self, mat_bnl: np.ndarray):
        """Per-node coefficient rows; mat index -1 maps to the rigid row."""
        idx = np.where(mat_bnl < 0, self.b.shape[0] - 1, mat_bnl)
        return {name: getattr(self, name)[idx]
                for name in ("b", "bd", "bDh", "bFh", "beta", "D", "E", "F")}
