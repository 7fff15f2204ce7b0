"""Cartesian grid (also hosts the FCC subgrid).

Semantics parity target: reference python/voxelizer/cart_grid.py:21-121:
grid covers the scene bbox plus an offset*h margin (offset > 2 guarantees the
three-layer halo needed by ABCs), dims forced even for FCC (so any axis can be
rotated and folded), and the grid vectors xv/yv/zv are saved to cart_grid.h5.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class CartGrid:
    def __init__(self, h: float, offset: float, bmin, bmax, fcc: bool = False):
        assert offset > 2.0, "need >= 3-layer halo for ABCs"
        bmin = np.asarray(bmin, np.float64)
        bmax = np.asarray(bmax, np.float64)

        xyzmin0 = bmin - offset * h
        xyzmax0 = bmax + offset * h

        N3 = np.int_(np.ceil((xyzmax0 - xyzmin0) / h)) + 1
        # guard the exact-division float edge: the last grid line must not
        # fall short of the requested upper bound
        for d in range(3):
            while xyzmin0[d] + (N3[d] - 1) * h < xyzmax0[d]:
                N3[d] += 1
        Nx, Ny, Nz = N3
        if fcc:  # even dims so any axis can be folded
            Nx += Nx % 2
            Ny += Ny % 2
            Nz += Nz % 2

        self.h = float(h)
        self.offset = offset
        self.fcc = fcc
        self.xv = np.arange(Nx) * h + xyzmin0[0]
        self.yv = np.arange(Ny) * h + xyzmin0[1]
        self.zv = np.arange(Nz) * h + xyzmin0[2]
        self.Nx, self.Ny, self.Nz = int(Nx), int(Ny), int(Nz)
        self.Nxyz = np.array([Nx, Ny, Nz], np.int64)
        self.Npts = int(np.prod(self.Nxyz))
        self.xyzmin = np.array([self.xv[0], self.yv[0], self.zv[0]])
        self.xyzmax = np.array([self.xv[-1], self.yv[-1], self.zv[-1]])
        assert np.all(self.xyzmin == xyzmin0)
        assert np.all(self.xyzmax >= xyzmax0)

    def print_stats(self):
        print(f"--CART_GRID: h={self.h} Nxyz={tuple(self.Nxyz)} Npts={self.Npts:g}")

    def save(self, save_folder):
        from pffdtd_jax.io.h5 import H5File

        folder = Path(save_folder)
        folder.mkdir(parents=True, exist_ok=True)
        kw = {"compression": "gzip", "compression_opts": 9}
        with H5File(folder / "cart_grid.h5", "w") as f:
            f.create_dataset("xv", data=self.xv, **kw)
            f.create_dataset("yv", data=self.yv, **kw)
            f.create_dataset("zv", data=self.zv, **kw)
            f.create_dataset("h", data=np.float64(self.h))
